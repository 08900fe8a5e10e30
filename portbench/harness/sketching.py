"""What the sketch entries share: the pool of genomes, the sketch's
parameters, the plain reference over the pool and the bounds of the work
its batches need."""

from __future__ import annotations

import numpy as np

from portbench.harness import counts, data
from portbench.harness.entry import Entry
from portbench.reference import sketch as ref_sketch


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


class SketchEntry(Entry):

    def _params(self):
        from hypergen_tpu_torch.params import SketchParams

        s = self.config["sketch"]
        return SketchParams(ksize=s["ksize"], scaled=s["scaled"],
                            hv_d=s["hv_d"], seed=s["seed"],
                            sketch_method=s["sketch_method"],
                            canonical=s["canonical"])

    def inputs(self) -> None:
        self.genomes = data.make_pool(self.config, self.seed, self.device)
        self.bases = np.array([g.bases for g in self.genomes], np.int64)
        self.lengths = np.array([sum(c.size for c in g.contigs)
                                 + len(g.contigs) - 1 for g in self.genomes],
                                np.int64)

    def _shapes(self, sketcher) -> None:
        """The sketcher's chunk, cells and slots a cell, and the bucket
        (chunks a row, a power of two) of each genome."""
        from hypergen_tpu_torch.models.sketcher import packed_cells

        self.chunk, self.cells = sketcher.C, packed_cells(sketcher.C)
        self.cap = sketcher.cell_cap
        k = self.config["sketch"]["ksize"]
        self.buckets = np.array([
            _next_pow2(-(-max(int(n) - k + 1, 1) // self.chunk))
            for n in self.lengths])

    def reference(self, hv_bits: int = 16):
        """(hv, norm2, n_hashes) of every genome of the pool."""
        return ref_sketch.sketch_genomes([g.codes() for g in self.genomes],
                                         self.config["sketch"], self.device,
                                         hv_bits=hv_bits)

    def _k1_s(self, idx: np.ndarray, n_chunks: int) -> float:
        """K1's bound over genomes idx padded to n_chunks chunks."""
        k = self.config["sketch"]["ksize"]
        n_pos = np.maximum(self.lengths[idx] - k + 1, 0)
        sec, _ = counts.k1_bound(len(idx), n_chunks * self.chunk // 16 + 4,
                                 int(n_pos.sum()), n_chunks, k, self.cap,
                                 self.cells)
        return sec

    def _encode_s(self, n_hashes: np.ndarray, idx: np.ndarray) -> float:
        """The encode's bound over the sketched rows idx."""
        sec, _ = counts.encode_bound(len(idx), int(n_hashes[idx].sum()),
                                     self.config["sketch"]["hv_d"])
        return sec
