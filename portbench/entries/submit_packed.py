"""A library caller's stream: the pool held as PackedGenomes, batches of
``batch`` consecutive genomes of an arrival order drawn from the seed (pass
after pass over the pool) through ``submit_batch_packed``, with up to
``in_flight`` batches in flight, each collected by ``collect_batch``."""

from __future__ import annotations

import collections
from typing import Dict, List, Tuple

import numpy as np

from portbench.harness import data
from portbench.harness.entry import Checks, rows_wrong
from portbench.harness.sketching import SketchEntry


class SubmitPacked(SketchEntry):

    def inputs(self) -> None:
        super().inputs()
        self.flight = collections.deque()
        self.stream = collections.deque()
        self.passes = 0
        self.submitted: List[np.ndarray] = []
        self.results: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []

    def setup(self) -> None:
        from hypergen_tpu_torch.io.fastx import packed_from_codes
        from hypergen_tpu_torch.models.sketcher import Sketcher

        self.inputs()
        self.packed = [packed_from_codes(g.codes()) for g in self.genomes]
        self.sk = Sketcher(self._params(), device=self.device)
        self._shapes(self.sk)
        B = self.mix["batch"]
        by_bucket = collections.defaultdict(list)
        for i in range(len(self.packed)):
            by_bucket[int(self.buckets[i])].append(i)
        for nc in sorted(by_bucket):  # each bucket at the stream's batch size
            idx = (by_bucket[nc] * B)[:B]
            self.sk.collect_batch(self.sk.submit_batch_packed(
                [self.packed[i] for i in idx]))

    def _next_batch(self) -> np.ndarray:
        B = self.mix["batch"]
        while len(self.stream) < B:
            self.stream.extend(data.rng(self.seed, 200 + self.passes)
                               .permutation(len(self.genomes)))
            self.passes += 1
        idx = np.array([self.stream.popleft() for _ in range(B)])
        self.submitted.append(idx)
        self.calls += 1
        return idx

    def _done(self, idx: np.ndarray, hv: np.ndarray, norm2: np.ndarray) -> None:
        self.results.append((idx, hv, norm2))
        self.work["genomes"] += len(idx)
        self.work["bases"] += int(self.bases[idx].sum())

    def _collect(self) -> None:
        idx, handle = self.flight.popleft()
        with self.span("collect"):
            res = self.sk.collect_batch(handle)
        self._done(idx, np.stack([r["hv"] for r in res]),
                   np.array([r["norm2"] for r in res], np.int64))

    def step(self) -> None:
        idx = self._next_batch()
        self.started += len(idx)
        with self.span("submit"):
            handle = self.sk.submit_batch_packed([self.packed[i] for i in idx])
        self.flight.append((idx, handle))
        if len(self.flight) >= self.mix["in_flight"]:
            self._collect()

    def drain(self) -> None:
        while self.flight:
            self._collect()

    def release(self) -> None:
        del self.sk

    def stand_in(self, outputs, calls: int) -> None:
        hv, norm2, _ = outputs
        for _ in range(calls):
            idx = self._next_batch()
            self._done(idx, hv[idx], norm2[idx].astype(np.int64))

    def check(self, want) -> Checks:
        hv, norm2, _ = want
        wrong = 0
        for idx, got_hv, got_n2 in self.results:
            wrong += rows_wrong(got_hv, got_n2, hv[idx], norm2[idx])
        missing = self.calls * self.mix["batch"] - sum(len(r[0]) for r in self.results)
        return {"rows_wrong": (wrong, 0), "rows_missing": (missing, 0)}

    def needed(self, want) -> Dict[str, float]:
        # a batch pads every row to the bucket of its longest genome
        n_hashes = want[2]
        k1 = sum(self._k1_s(idx, int(self.buckets[idx].max()))
                 for idx in self.submitted)
        encode = sum(self._encode_s(n_hashes, idx) for idx in self.submitted)
        return {"k1_s": k1, "encode_s": encode}


ENTRY = SubmitPacked
