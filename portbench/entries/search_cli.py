"""``run_search_cli`` as ``search -r DB.hgdb -q Q.hgdb --top_k K -a A`` runs
it, on the cell's cards, each call loading both .hgdb directories (the load
in a span of its own) and writing its TSV."""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, List

from portbench.harness import counts, data
from portbench.harness.entry import Checks, Entry, lines_wrong
from portbench.reference import search as ref_search


class SearchCli(Entry):

    def inputs(self) -> None:
        self.db, self.q = data.make_database(self.config, self.mix, self.seed,
                                             self.device)
        self.out = self.tmp / "out"
        self.out.mkdir()
        self.outputs: List[Path] = []

    def setup(self) -> None:
        from hypergen_tpu_torch.io.sketch_db import load_sharded_db

        self.inputs()
        sk = self.config["sketch"]
        self.ref_dir, self.q_dir = self.tmp / "ref.hgdb", self.tmp / "queries.hgdb"
        data.write_hgdb(self.db, self.ref_dir, sk, self.config["shards"])
        data.write_hgdb(self.q, self.q_dir, sk, self.mix["query_shards"])

        def load(path):
            with self.span("load_db"):
                return load_sharded_db(path)

        self.load = load
        self._call(self.tmp / "warm.tsv")

    def _call(self, out: Path) -> None:
        from hypergen_tpu_torch.parallel.search import run_search_cli

        args = argparse.Namespace(path_r=self.ref_dir, path_q=self.q_dir,
                                  out=out, top_k=self.mix["top_k"],
                                  ani_th=self.mix["ani_threshold"])
        with self.span("search_call"):
            run_search_cli(args, self.load, self.devices)

    def _next(self) -> Path:
        return self.out / f"call{self.calls:04d}.tsv"

    def _done(self, out: Path) -> None:
        self.outputs.append(out)
        self.calls += 1
        self.work["queries"] += len(self.q.names)

    def step(self) -> None:
        self.started += len(self.q.names)
        out = self._next()
        self._call(out)
        self._done(out)

    def reference(self, hv_bits: int = 16) -> List[str]:
        """The TSV's lines."""
        return ref_search.search_tsv(
            self.db.hvs, self.db.norms, self.db.names, self.q.hvs,
            self.q.norms, self.q.names, self.config["sketch"]["ksize"],
            self.mix["top_k"], self.mix["ani_threshold"], self.device,
            hv_bits=hv_bits)

    def stand_in(self, outputs: List[str], calls: int) -> None:
        for _ in range(calls):
            out = self._next()
            out.write_text("".join(outputs))
            self._done(out)

    def check(self, want: List[str]) -> Checks:
        wrong = 0
        for out in self.outputs:
            wrong += lines_wrong(out.read_text().splitlines(keepends=True), want)
        return {"tsv_rows_wrong": (wrong, 0)}

    def needed(self, want) -> Dict[str, float]:
        M, N, D = len(self.db.names), len(self.q.names), self.db.hvs.shape[1]
        sec, _ = counts.search_bound(M, N, D, self.mix["top_k"])
        return {"search_s": self.calls * sec}


ENTRY = SearchCli
