"""``Sketcher(params).sketch_files(paths)``, then ``sketches_to_db`` and
``dump_sharded_db``: the CLI's ``sketch -o X.hgdb --shards n``. Each call
sketches the pool under ``copies`` names of each file, in an order drawn
from the seed, at the mix's ``pipeline_depth``, into ``shards`` shards."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List

import numpy as np

from portbench.harness import data
from portbench.harness.entry import Checks, rows_wrong
from portbench.harness.sketching import SketchEntry


class SketchFiles(SketchEntry):

    def inputs(self) -> None:
        super().inputs()
        self.params = self._params()
        self.names: List[Path] = []
        self.owner: Dict[str, int] = {}  # a name's genome
        for c in range(self.mix["copies"]):
            for i, g in enumerate(self.genomes):
                link = self.tmp / "names" / f"c{c}" / f"{g.name}.fna"
                self.names.append(link)
                self.owner[str(link)] = i
        self.out = self.tmp / "out"
        self.out.mkdir()
        self.outputs: List[Path] = []
        self.called: List[np.ndarray] = []

    def setup(self) -> None:
        from hypergen_tpu_torch.models.sketcher import Sketcher

        self.inputs()
        pool = data.write_pool(self.genomes, self.tmp / "pool",
                               self.config["assumed"]["line_width"])
        for link in self.names:
            link.parent.mkdir(parents=True, exist_ok=True)
            link.symlink_to(pool[self.owner[str(link)]])
        self._shapes(Sketcher(self.params, device=self.device))
        self._call(pool, self.tmp / "warm.hgdb")  # every bucket, full batches
        self.stages.clear()

    def _call(self, paths, out: Path) -> None:
        from hypergen_tpu_torch.io.sketch_db import dump_sharded_db, sketches_to_db
        from hypergen_tpu_torch.models.sketcher import Sketcher

        with self.span("sketch_files"):
            sk = Sketcher(self.params, device=self.device)
            sketches = sk.sketch_files(paths, progress=False,
                                       pipeline_depth=self.mix["pipeline_depth"])
        for name, s in sk.last_stage_times.items():
            self.stages[name] += s
        with self.span("db_write"):
            db = sketches_to_db(sketches)
            db.sketch_method = self.params.sketch_method
            dump_sharded_db(db, out, n_shards=self.mix["shards"])

    def _next(self):
        """The next call's paths, their genomes and its output."""
        order = data.rng(self.seed, 100 + self.calls).permutation(len(self.names))
        paths = [self.names[i] for i in order]
        idx = np.array([self.owner[str(p)] for p in paths])
        return paths, idx, self.out / f"call{self.calls:04d}.hgdb"

    def _done(self, idx: np.ndarray, out: Path) -> None:
        self.outputs.append(out)
        self.called.append(idx)
        self.calls += 1
        self.work["genomes"] += len(idx)
        self.work["bases"] += int(self.bases[idx].sum())

    def step(self) -> None:
        self.started += len(self.names)
        paths, idx, out = self._next()
        self._call(paths, out)
        self._done(idx, out)

    def stand_in(self, outputs, calls: int) -> None:
        hv, norm2, _ = outputs
        for _ in range(calls):
            paths, idx, out = self._next()
            data.write_hgdb(data.Rows([str(p) for p in paths], hv[idx],
                                      norm2[idx]),
                            out, self.config["sketch"], self.mix["shards"])
            self._done(idx, out)

    def check(self, want) -> Checks:
        hv, norm2, _ = want
        wrong = missing = 0
        for out, idx in zip(self.outputs, self.called):
            try:
                rows = data.read_hgdb(out)
            except (OSError, ValueError, KeyError) as e:
                print(f"portbench: {out.name} unreadable: {e}")
                missing += len(idx)
                continue
            got = {n: r for r, n in enumerate(rows.names)}
            found = [(got[n], g) for n, g in self.owner.items() if n in got]
            missing += len(self.owner) - len(found)
            r, g = (np.array(x, np.int64) for x in zip(*found)) if found else \
                (np.zeros(0, np.int64),) * 2
            wrong += rows_wrong(rows.hvs[r], rows.norms[r].astype(np.int64),
                                hv[g], norm2[g].astype(np.int64))
            wrong += len(rows.names) - len(got)  # a name written twice
        return {"rows_wrong": (wrong, 0), "rows_missing": (missing, 0)}

    def needed(self, want) -> Dict[str, float]:
        # sketch_files batches genomes of one bucket: each row's own shape
        n_hashes = want[2]
        k1 = encode = 0.0
        for idx in self.called:
            for nc in np.unique(self.buckets[idx]):
                k1 += self._k1_s(idx[self.buckets[idx] == nc], int(nc))
            encode += self._encode_s(n_hashes, idx)
        return {"k1_s": k1, "encode_s": encode}


ENTRY = SketchFiles
