"""``cli.run_dist`` as ``dist -r C.hgdb -q C.hgdb -a A`` runs it: the whole
collection against itself (the symmetric path) on the cell's first card,
each call loading the .hgdb and writing its TSV. The collection is made as
the search cells' database is (the same rows at the same seed where the
configurations agree), without queries, in a seeded order: a catalogue is
sketched in file-name or accession order, not sorted by species, so a
family's members fall in rows far apart."""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, List

from portbench.harness import data, spec
from portbench.harness.dist_counts import dist_bound
from portbench.reference import dist as ref_dist

# the program's spans a call is split into, summed into ``stages`` (seconds)
SPLIT = ("db_load_manifest", "db_load_assemble", "db_load_read",
         "dist_preload", "dist_compare", "dist_fetch", "dist_host_chain",
         "dist_finish", "dist_report")


class DistCli(spec.entry("search_cli")):

    def inputs(self) -> None:
        db, _ = data.make_database(
            self.config, {"queries": 0, "self_queries": 0}, self.seed,
            self.device)
        order = data.rng(self.seed, 5).permutation(len(db.names))
        self.db = data.Rows([db.names[i] for i in order], db.hvs[order],
                            db.norms[order])
        # the calls' work: every genome is screened against the collection
        self.q = self.db
        self.out = self.tmp / "out"
        self.out.mkdir()
        self.outputs: List[Path] = []

    def setup(self) -> None:
        self.inputs()
        self.db_dir = self.tmp / "collection.hgdb"
        data.write_hgdb(self.db, self.db_dir, self.config["sketch"],
                        self.config["shards"])
        self._call(self.tmp / "warm.tsv")

    def _call(self, out: Path) -> None:
        from hypergen_tpu_torch.cli import run_dist
        from hypergen_tpu_torch.utils.timing import SPANS

        sk = self.config["sketch"]
        args = argparse.Namespace(
            path_r=self.db_dir, path_q=self.db_dir, out=out,
            ksize=sk["ksize"], hv_d=sk["hv_d"],
            ani_th=self.mix["ani_threshold"], device=str(self.device))
        before = {k: SPANS[k].ns for k in SPLIT}
        with self.span("dist_call"):
            run_dist(args)
        for k, ns in before.items():
            self.stages[k] += (SPANS[k].ns - ns) / 1e9

    def reference(self, hv_bits: int = 16) -> List[str]:
        """The TSV's lines."""
        return ref_dist.dist_tsv(
            self.db.hvs, self.db.norms, self.db.names,
            self.config["sketch"]["ksize"], self.mix["ani_threshold"],
            self.device, hv_bits=hv_bits)

    def needed(self, want) -> Dict[str, float]:
        M, D = self.db.hvs.shape
        sec, _ = dist_bound(M, D, len(want))
        return {"dist_s": self.calls * sec}


ENTRY = DistCli
