"""The sketcher: packed genomes -> sketch hypervectors, on one device.

Counterpart of the packed path of ``hypergen_tpu.models.sketcher``
(``make_sketch_step(validity="packed")`` and ``Sketcher``). One step per
batch of same-bucket genomes, enqueued on the device's current stream at
capacities fixed on the host, so that nothing in it waits for the card:

  packed 2-bit words [B, W] + invalid runs + n_pos [B], packed into one
  host buffer (pinned on a CUDA device) and uploaded in one copy
    -> K1 (``ops.kernels.hash_kernel``): unpack, rolling canonical k-mer,
       t1ha2, FracMinHash threshold, per-cell survivor slots (``cap`` a
       cell) + true cell counts
    -> compaction of the survivors with their positions into a fixed
       width (``ops.compact.compact_to_width``)
    -> run postfilter: drop windows that overlap an invalid run
    -> the distinct survivor hashes of each genome
    -> the HV encode with its i16 wrap and wrapping-i32 norm^2
       (``ops.kernels.encode_kernel``: one CUDA kernel and its tail)
    -> copied to host tensors (pinned on a CUDA device), then an event

``submit_batch_packed`` returns a handle at once; ``collect_batch`` waits
for the handle's event and reads the true counts. If a cell held more
survivors than its slots, or a genome more than the width, it grows that
capacity (as the JAX package's ``_finalize_batch``) and reruns the batch
from the host inputs the handle keeps: nothing is dropped, and the result
is the one a run without overflow gives. ``sketch_files`` keeps up to
``pipeline_depth`` batches in flight while its thread parses and packs.

K1 hashes every position as if valid; windows that touch an N run, a
record separator or the padding are removed exactly by the postfilter. The
HV is a sum over the *set* of surviving hashes, so the result does not
depend on batching, bucketing or the cell geometry.

A genome whose bucket reaches ``seqpar_min_chunks`` chunks (~67 Mbp at the
default chunk size: plant and fungal assemblies) leaves the batches. On a
CUDA device it runs alone as a one-row batch of the same step while its
positions fit K1's int32 positions and its measured memory fits the card
(``ONE_ROW_*`` below): on the H100 that is the fastest route. Above that,
when the Sketcher may use more than one CUDA card (``seqpar_devices``:
every card of the host by default, only its own card in a pod process) it
is split over them (``parallel.seqpar``, K2); otherwise, and always on the
CPU as in the JAX package, it streams through the same K1 step in
fixed-size tiles whose survivor sets are merged on the host and encoded
once (``sketch_packed_tiled``). These routes run synchronously.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from hypergen_tpu_torch.io.fastx import (
    PackedGenome,
    codes_from_packed,
    packed_from_codes,
    read_genome_packed,
)
from hypergen_tpu_torch.io.sketch_db import FileSketch
from hypergen_tpu_torch.params import SketchParams
from hypergen_tpu_torch.ops.compact import compact_to_width
from hypergen_tpu_torch.ops.kernels.encode_kernel import encode_hv_i16
from hypergen_tpu_torch.ops.kernels.hash_kernel import (
    MAX_POSITIONS,
    hash_packed_rows,
)
from hypergen_tpu_torch.utils.timing import SketchTimer

log = logging.getLogger("hypergen")

# start of a padding run row: no window end reaches it, since every row of
# a batch (a genome or a tile) has fewer than 2^31 codes
# (Sketcher._one_row_fits, Sketcher._tile_genome)
_NO_RUN = np.int32(0x7FFFFFFF)

# Routing of huge genomes on a CUDA device (Sketcher._one_row_fits). A
# one-row batch's peak allocated memory is its packed words (C/4 bytes a
# chunk) and ONE_ROW_BYTES_PER_SLOT for each of K1's n_chunks*cells*cap
# slots: h, pos and valid (13 bytes) and the compaction's prefix sum (16:
# cumsum's int64 copy of the mask and its int64 result). chip_smoke.py
# phase 9 measures it on the card at 2^27, 2^29 and 2^31 - 1 bp (29.02
# bytes a slot on an H100) and fails if any peak exceeds the estimate. The
# router doubles the estimate as a margin (one step of the cell-cap ladder)
# and keeps ONE_ROW_RESERVE free for the encode and the allocator.
ONE_ROW_BYTES_PER_SLOT = 32
ONE_ROW_RESERVE = 2 << 30


def packed_row_words(n_chunks: int, chunk_positions: int) -> int:
    """u32 words per genome row (16 codes a word; the slack words cover the
    last cell's halo read)."""
    return n_chunks * chunk_positions // 16 + 4


def packed_cells(chunk_positions: int) -> int:
    """K1 cell count for a chunk size (cells must divide C/16 and be a
    multiple of 128), in the JAX package's order of preference, so that
    both packages cut chunks into the same cells. 0 = C is too small or
    misaligned."""
    for c in (2048, 4096, 1024, 128):
        if chunk_positions % (16 * c) == 0:
            return c
    return 0


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def filter_positions_by_runs(
    pos: torch.Tensor, runs: torch.Tensor, ksize: int
) -> torch.Tensor:
    """Which k-mer windows avoid every invalid run.

    pos: int32 [B, S] genome-global k-mer starts (window [p, p+k)).
    runs: int32 [B, R, 2] disjoint [start, end) runs sorted by start,
    padded with rows that start at INT32_MAX. Returns bool [B, S].

    The run with the largest start below p+k is the only candidate: runs
    are disjoint and sorted, so their ends increase with their starts, and
    that run has the largest end of all runs starting before p+k.
    """
    starts = runs[..., 0].contiguous().to(torch.int64)
    ends = runs[..., 1].to(torch.int64)
    p = pos.to(torch.int64)
    idx = torch.searchsorted(starts, p + ksize) - 1  # last start < p + k
    end = torch.gather(ends, 1, idx.clamp(min=0))
    return (idx < 0) | (end <= p)


def distinct_hashes(
    h: torch.Tensor, keep: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise distinct kept hashes: (sorted h [B, N], first-occurrence
    mask [B, N]). Dropped entries become U64_MAX (-1), which no survivor can
    be (the keep test is a strict h < threshold <= U64_MAX)."""
    hs = torch.sort(torch.where(keep, h, -1), dim=-1).values
    prev = torch.nn.functional.pad(hs[:, :-1], (1, 0), value=-1)
    return hs, (hs != -1) & (hs != prev)


class HostBatch(NamedTuple):
    """A step's host inputs: int32 views of one host buffer ``buf`` (pinned
    on a CUDA device), uploaded in one copy. words [B, W] holds u32 bits,
    as K1 takes them; runs [B, R, 2] the invalid runs padded with rows at
    _NO_RUN to the batch's largest run count; n_pos [B] the k-mer counts."""

    buf: torch.Tensor
    words: np.ndarray
    runs: np.ndarray
    n_pos: np.ndarray


@dataclasses.dataclass
class SketchHandle:
    """A batch in flight (Sketcher.submit_batch_packed): what collect needs
    to read its outputs, check its capacities and rerun it."""

    n: int  # genomes (rows)
    n_chunks: int
    host: HostBatch
    cap: int  # K1 slots a cell
    width: int  # compaction width
    hashes: bool  # outputs: the distinct hashes (tiles), not the HV
    out: Tuple[torch.Tensor, ...]  # on the host (pinned on a CUDA device)
    device_out: Tuple[torch.Tensor, ...]  # read by the copy; kept until collect
    event: Optional[torch.cuda.Event]  # recorded after the copy; None: CPU


class Sketcher:
    """Batched genome sketcher on one torch device.

    Equivalent of the reference sketch orchestrator
    (reference:src/sketch.rs:12-69), with the per-genome hot loops on the
    device and FASTA parsing in a thread pool.
    """

    def __init__(
        self,
        params: SketchParams,
        device="cuda",
        chunk_positions: int = 1 << 17,
        batch: int = 8,
        seqpar_min_chunks: int = 512,
        seqpar_devices: Optional[Sequence] = None,
    ):
        """seqpar_devices: the CUDA cards a huge genome may be split over;
        None = every card of the host. A pod process passes its own card
        only, so that its route never reaches another rank's card."""
        params.validate()
        self.params = params
        self.device = torch.device(device)
        self.seqpar_devices = (None if seqpar_devices is None else
                               [torch.device(d) for d in seqpar_devices])
        self.seqpar_min_chunks = int(seqpar_min_chunks)
        self.C = int(chunk_positions)
        self.cells = packed_cells(self.C)
        if not self.cells:
            raise ValueError(
                f"chunk positions {self.C} must be a multiple of 2048"
            )
        self.lsub = self.C // self.cells
        self.batch = int(batch)
        # slots per cell: 8x the expected survivors of a cell, at least 4
        self.cell_cap = int(
            min(max(4, -(-8 * self.lsub // max(params.scaled, 1))), self.lsub)
        )
        # per-bucket growth of the compaction width: one repeat-rich genome
        # must not widen every other bucket's step
        self._enc_overflow_factor: Dict[int, int] = {}
        # capacity reruns at collect, by capacity ("cell_cap", "width")
        self.retries: Dict[str, int] = collections.Counter()
        self._timer: Optional[SketchTimer] = None  # set inside sketch_files
        self.last_stage_times: Dict[str, float] = {}
        self.last_device_times: Dict[str, float] = {}

    def _stage(self, name: str, device: bool = False):
        """A span of the stage timer (device=True: timed on the device's
        stream); nothing while no timer is set (outside sketch_files)."""
        if self._timer is None:
            return contextlib.nullcontext()
        return self._timer.stage(name, device)

    def _bucket(self, L: int) -> int:
        """Chunks per row for a genome of L codes: a power of two."""
        n_pos = max(L - self.params.ksize + 1, 1)
        return _next_pow2(-(-n_pos // self.C))

    def _enc_cap(self, n_chunks: int) -> int:
        """Compaction width of a bucket: the JAX package's encode capacity,
        2x the expected survivors + 512, times the bucket's overflow
        factor, rounded up to 256. Survivors ~ Binomial(n_pos, 1/scaled)
        plus repeat occurrences; the collect-time check makes an
        undersized width a rerun, never a wrong sketch."""
        cap = self._enc_cap_base(n_chunks)
        cap *= self._enc_overflow_factor.get(n_chunks, 1)
        return int(-(-cap // 256) * 256)

    def _enc_cap_base(self, n_chunks: int) -> int:
        expected = n_chunks * self.C // max(self.params.scaled, 1)
        return 2 * expected + 512

    def _prepare_batch(self, genomes: List[PackedGenome], n_chunks: int
                       ) -> HostBatch:
        """Host inputs for one step (HostBatch), for genomes that fit in
        n_chunks chunks. Each call packs into a buffer of its own; on a
        CUDA device it comes from PyTorch's pinned host allocator, which
        hands a block out again only once the copies that read it have
        completed, so a later pack never overwrites bytes in flight.

        The one place where runs become int32: a run coordinate at or above
        2^31 raises (the router sends no such genome here; a tile's runs
        are in tile coordinates)."""
        k = self.params.ksize
        for g in genomes:
            if g.runs.size and int(g.runs.max()) > _NO_RUN:
                raise ValueError(
                    f"invalid run up to {int(g.runs.max())} in a batch row: "
                    f"run coordinates must be below 2^31 (tile the genome)"
                )
        B = len(genomes)
        W = packed_row_words(n_chunks, self.C)
        R = max([1] + [g.runs.shape[0] for g in genomes])
        buf = torch.empty(B * (W + 2 * R + 1), dtype=torch.int32,
                          pin_memory=self.device.type == "cuda")
        flat = buf.numpy()
        words = flat[: B * W].reshape(B, W)
        runs = flat[B * W : B * (W + 2 * R)].reshape(B, R, 2)
        n_pos = flat[B * (W + 2 * R) :]
        row_bytes = words.view(np.uint8)
        for i, g in enumerate(genomes):
            nb = min(g.packed2.shape[0], W * 4)
            row_bytes[i, :nb] = g.packed2[:nb]
            row_bytes[i, nb:] = 0
            runs[i, : g.runs.shape[0]] = g.runs
            runs[i, g.runs.shape[0] :] = _NO_RUN
            n_pos[i] = max(g.length - k + 1, 0)
        return HostBatch(buf, words, runs, n_pos)

    def _enqueue(self, host: HostBatch, n_chunks: int, cap: int, width: int,
                 hashes: bool) -> SketchHandle:
        """Enqueue the whole step on the device's current stream, with K1
        at `cap` slots a cell and the compaction at `width`; nothing here
        reads the device. Outputs per row: the HV (int16 [B, D]) and meta
        int64 [B, 4] = (norm2, n_hashes, cell_max, survivors); with
        hashes=True the sorted hashes int64 [B, width] and their
        first-occurrence mask in place of the HV (norm2 0)."""
        p = self.params
        B, W = host.words.shape
        R = host.runs.shape[1]
        with self._stage("upload", device=True):
            buf = host.buf.to(self.device, non_blocking=True)
            words = buf[: B * W].view(B, W)
            runs = buf[B * W : B * (W + 2 * R)].view(B, R, 2)
            n_pos = buf[B * (W + 2 * R) :]
        with self._stage("hash", device=True):
            h, pos, valid, cell_max = hash_packed_rows(
                words, n_pos, n_chunks, self.C, p.ksize, p.seed, p.threshold,
                canonical=p.canonical, method=p.sketch_method,
                cells=self.cells, cap=cap,
            )
        with self._stage("compact", device=True):
            (h, pos), count = compact_to_width(valid, width, h, pos)
            filled = torch.arange(width, device=h.device) < count[:, None]
            clean = filled & filter_positions_by_runs(pos, runs, p.ksize)
        with self._stage("distinct", device=True):
            hs, first = distinct_hashes(h, clean)
        n_hashes = first.sum(dim=-1)
        if hashes:
            norm2, outs = torch.zeros_like(n_hashes), (hs, first)
        else:
            with self._stage("encode", device=True):
                hv16, norm2 = encode_hv_i16(hs, first, p.hv_d)
                outs = (hv16,)
        meta = torch.stack(
            [norm2.to(torch.int64), n_hashes, cell_max.to(torch.int64),
             count], dim=-1)
        device_out = (*outs, meta)
        event = None
        with self._stage("download", device=True):
            if self.device.type == "cuda":
                out = tuple(
                    torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    .copy_(t, non_blocking=True) for t in device_out)
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
            else:
                out = tuple(t.cpu() for t in device_out)
        return SketchHandle(B, n_chunks, host, cap, width, hashes, out,
                            device_out, event)

    def _submit(self, genomes: List[PackedGenome], n_chunks: int,
                hashes: bool = False) -> SketchHandle:
        with self._stage("pack"):
            host = self._prepare_batch(genomes, n_chunks)
        with self._stage("dispatch"):
            return self._enqueue(host, n_chunks, self.cell_cap,
                                 self._enc_cap(n_chunks), hashes)

    def submit_batch_packed(self, genomes: List[PackedGenome]
                            ) -> SketchHandle:
        """Enqueue one step over 1 to `batch` genomes (PackedGenome) in the
        bucket of the longest and return its handle without waiting for
        the card; collect_batch(handle) gives the results."""
        if not 1 <= len(genomes) <= self.batch:
            raise ValueError(f"batch size must be in [1, {self.batch}]")
        return self._submit(genomes,
                            max(self._bucket(g.length) for g in genomes))

    def submit_batch(self, codes_list: List[np.ndarray]) -> SketchHandle:
        """submit_batch_packed of genomes given as flat code arrays (uint8
        0-3, INVALID = 4), packed on the host here; sketch_files parses
        straight into PackedGenomes instead."""
        return self.submit_batch_packed(
            [packed_from_codes(np.asarray(c, dtype=np.uint8))
             for c in codes_list])

    def submit(self, codes: np.ndarray) -> SketchHandle:
        """submit_batch of one genome."""
        return self.submit_batch([codes])

    def collect_batch(self, handle: SketchHandle) -> List[Dict[str, object]]:
        """Wait for one handle's step and return per genome {"hv": int16
        [D] numpy, "norm2": int, "n_hashes": int} (with hashes=True, each
        row's distinct hashes, int64 numpy). A capacity that overflowed
        grows (the cell cap to min(next_pow2(cell_max), C/cells), the
        bucket's width factor as the JAX package's) and the batch reruns
        synchronously from its host inputs, at most 7 times."""
        with self._stage("collect"):
            for _ in range(7):
                if handle.event is not None:
                    handle.event.synchronize()
                meta = handle.out[-1].numpy()
                cell_max = int(meta[:, 2].max())
                survivors = int(meta[:, 3].max())
                if cell_max <= handle.cap and survivors <= handle.width:
                    return self._results(handle, meta)
                cap = handle.cap
                if cell_max > cap:
                    log.warning("survivor cap overflow (%d > %d); retrying",
                                cell_max, cap)
                    self.retries["cell_cap"] += 1
                    cap = min(_next_pow2(cell_max), self.lsub)
                if survivors > handle.width:
                    log.warning("compaction width overflow (%d > %d); "
                                "retrying", survivors, handle.width)
                    self.retries["width"] += 1
                    nc = handle.n_chunks
                    need = -(-survivors // self._enc_cap_base(nc))
                    self._enc_overflow_factor[nc] = max(
                        self._enc_overflow_factor.get(nc, 1) * 2,
                        _next_pow2(need),
                    )
                handle = self._enqueue(handle.host, handle.n_chunks, cap,
                                       self._enc_cap(handle.n_chunks),
                                       handle.hashes)
        raise RuntimeError("sketcher capacity retry limit exceeded")

    @staticmethod
    def _results(handle: SketchHandle, meta: np.ndarray) -> list:
        if handle.hashes:
            hs, first = (t.numpy() for t in handle.out[:2])
            return [hs[i][first[i]] for i in range(handle.n)]
        hv16 = handle.out[0].numpy().copy()  # let the pinned block go
        return [
            {"hv": hv16[i], "norm2": int(meta[i, 0]),
             "n_hashes": int(meta[i, 1])}
            for i in range(handle.n)
        ]

    def collect_batches(self, handles: Sequence[SketchHandle]
                        ) -> List[List[Dict[str, object]]]:
        """collect_batch of each handle, in the handles' order (any order
        of submission)."""
        return [self.collect_batch(h) for h in handles]

    def collect(self, handle: SketchHandle) -> Dict[str, object]:
        """The one result of a submit(codes) handle."""
        return self.collect_batch(handle)[0]

    def sketch_batch(self, genomes: List[PackedGenome]) -> List[Dict[str, object]]:
        """Sketch up to `batch` genomes in one step on the device:
        collect_batch(submit_batch_packed(genomes)); [] for none."""
        if not genomes:
            return []
        return self.collect_batch(self.submit_batch_packed(genomes))

    # -- single-device huge genomes: bounded fixed-shape tiling -------------

    def _tile_genome(self, g: PackedGenome, tile_chunks: int
                     ) -> List[PackedGenome]:
        """Split a genome into tiles of tile_chunks chunks, each covering a
        disjoint k-mer start range [t*TC, (t+1)*TC) plus the k-1 halo.
        Tile t has length n_pos_t + k - 1, a byte-aligned packed2 slice
        (TC % 4 == 0), and its parent's runs clipped and shifted into tile
        coordinates: clipped in int64 (a genome may hold 2^31 codes or
        more), then int32, since a tile's coordinates are at most its
        length TC + k - 1."""
        k = self.params.ksize
        TC = tile_chunks * self.C
        total_pos = max(g.length - k + 1, 0)
        n_tiles = max(-(-total_pos // TC), 1)
        runs = g.runs.astype(np.int64, copy=False)
        tiles = []
        for t in range(n_tiles):
            start = t * TC
            L_t = min(total_pos - start, TC) + k - 1
            p2 = g.packed2[start // 4 : start // 4 + -(-L_t // 4)]
            lo = np.clip(runs[:, 0] - start, 0, L_t)
            hi = np.clip(runs[:, 1] - start, 0, L_t)
            keep = hi > lo
            runs_t = np.stack([lo[keep], hi[keep]], axis=-1).astype(np.int32)
            tiles.append(PackedGenome(p2, runs_t, L_t))
        return tiles

    def sketch_packed_tiled(
        self, g: PackedGenome, tile_chunks: Optional[int] = None
    ) -> Dict[str, object]:
        """Sketch ONE huge genome on ONE device in bounded memory.

        Tiles of tile_chunks chunks (default seqpar_min_chunks // 8) go
        through the step `batch` at a time, one batch after another; each
        tile's distinct survivor hashes come to the host, whose np.unique
        union is the genome's distinct set (dedup composes as set union),
        encoded once on the device (the bundle is a sum). The result
        equals the one-shot step's bit for bit. Device memory is
        O(batch * tile_chunks * C), host memory O(survivors).
        """
        if tile_chunks is None:
            tile_chunks = max(1, self.seqpar_min_chunks // 8)
        tiles = self._tile_genome(g, tile_chunks)
        parts = [np.zeros(0, dtype=np.int64)]
        for lo in range(0, len(tiles), self.batch):
            parts.extend(self.collect_batch(self._submit(
                tiles[lo : lo + self.batch], tile_chunks, hashes=True)))
        merged = np.unique(np.concatenate(parts).view(np.uint64)).view(np.int64)
        h = torch.from_numpy(merged).to(self.device)[None]
        with self._stage("encode", device=True):
            hv16, norm2 = encode_hv_i16(
                h, torch.ones_like(h, dtype=torch.bool), self.params.hv_d)
        return {"hv": hv16[0].cpu().numpy(), "norm2": int(norm2[0]),
                "n_hashes": int(merged.shape[0])}

    def _one_row_bytes(self, n_chunks: int) -> int:
        """Peak allocated bytes of a one-row batch of n_chunks chunks, by
        the measured model (ONE_ROW_BYTES_PER_SLOT)."""
        slots = self.cells * self.cell_cap
        return n_chunks * (self.C // 4 + slots * ONE_ROW_BYTES_PER_SLOT)

    def _one_row_fits(self, length: int) -> bool:
        """Whether the one-row batch can take a genome of `length` codes on
        this CUDA device: its row fits K1 (MAX_POSITIONS), every window end
        p + k <= length stays below the padding run start INT32_MAX, and
        twice _one_row_bytes plus ONE_ROW_RESERVE fits in the device's free
        memory."""
        n_chunks = self._bucket(length)
        if length >= MAX_POSITIONS or n_chunks * self.C > MAX_POSITIONS:
            return False
        free, _ = torch.cuda.mem_get_info(self.device)
        return 2 * self._one_row_bytes(n_chunks) + ONE_ROW_RESERVE <= free

    def _huge_route(self, g: PackedGenome) -> Tuple[str, list]:
        """(route, cards) of a huge genome; see _sketch_huge."""
        if self.device.type == "cuda":
            if self._one_row_fits(g.length):
                return "one_row", []
            cards = self.seqpar_devices
            if cards is None:
                cards = [torch.device("cuda", i)
                         for i in range(torch.cuda.device_count())]
            if len(cards) > 1:
                return "seqpar", cards
        return "tiled", []

    def _sketch_huge(self, g: PackedGenome) -> Dict[str, object]:
        """A genome at or above seqpar_min_chunks. On a CUDA device it runs
        as a one-row batch where that fits (``_one_row_fits``: the fastest
        route on the H100); above that it is split over seqpar_devices when
        they are several cards, else tiled on this device. On the CPU it is
        tiled, as the JAX package routes it. In sketch_files the route is
        the span ``huge:<route>``, charged with what its steps' own spans
        do not cover."""
        route, cards = self._huge_route(g)
        with self._stage(f"huge:{route}"):
            if route == "one_row":
                return self.sketch_batch([g])[0]
            if route == "seqpar":
                # imported here: seqpar imports this module
                from hypergen_tpu_torch.parallel.seqpar import (
                    sketch_codes_seqpar,
                )

                return sketch_codes_seqpar(
                    codes_from_packed(g), self.params, cards,
                    chunk_positions=self.C,
                )
            return self.sketch_packed_tiled(g)

    def sketch_codes(self, codes: np.ndarray) -> Dict[str, object]:
        """Sketch one genome given flat base codes (uint8 0-3, INVALID = 4):
        {"hv": int16 [D] numpy, "norm2": int, "n_hashes": int}. It is
        packed (``packed_from_codes``) and routed as sketch_files routes a
        genome: one batch below seqpar_min_chunks, _sketch_huge at or
        above it."""
        g = packed_from_codes(np.asarray(codes, dtype=np.uint8))
        if self._bucket(g.length) >= self.seqpar_min_chunks:
            return self._sketch_huge(g)
        return self.sketch_batch([g])[0]

    def sketch_file(self, path) -> FileSketch:
        """The FileSketch of one genome file: sketch_files([path])[0]."""
        return self.sketch_files([path], progress=False)[0]

    def _to_filesketch(self, res: Dict[str, object], name: str) -> FileSketch:
        p = self.params
        if p.if_compressed:
            return FileSketch.from_dense(
                res["hv"], res["norm2"], name, p.ksize, p.scaled,
                p.canonical, p.seed,
            )
        # quant_bits 0 marks a dense (uncompressed) record
        return FileSketch(
            ksize=p.ksize, scaled=p.scaled, canonical=p.canonical, seed=p.seed,
            hv_d=p.hv_d, hv_quant_bits=0, hv_norm_2=res["norm2"],
            file_str=name, hv=np.asarray(res["hv"], dtype=np.int16),
        )

    def sketch_files(
        self,
        paths: Sequence,
        progress: bool = True,
        pipeline_depth: int = 3,
        io_threads: int = 0,
        read_ahead: int = 0,
    ) -> List[FileSketch]:
        """Sketch many genome files, in input order.

        Files are parsed in a pool of io_threads threads (0: min(threads,
        16), at least 1) through a bounded read-ahead window of read_ahead
        files (0: max(8 x batch, 2 x io_threads)), so memory stays bounded
        for any folder. Same-bucket genomes within the window are grouped
        into batches; partial groups run at the end. Up to pipeline_depth
        batches are in flight: the oldest is collected when the window is
        full, so this thread parses and packs the next batches while the
        device runs the earlier ones (1: each batch is collected right
        after its submit). A huge genome waits for the window to drain
        (its route sizes itself by the device's free memory) and runs
        synchronously. progress=False turns the progress bar off.

        Each call times its stages (utils.timing.SketchTimer): the host
        spans' totals in seconds, which add up to the call's wall time,
        land in ``last_stage_times``, and on a CUDA device the device
        spans' (CUDA events on its stream, read after the last collect) in
        ``last_device_times``; with HG_STAGE_TIMING set the table is
        logged at INFO. ``io_pool`` is the I/O pool's own time (submitting
        parses, which starts its threads, and its shutdown), ``fasta_read``
        the wait on a parse, ``collect`` the wait on the device.
        """
        from hypergen_tpu_torch.utils.progress import ProgressBar

        paths = list(paths)
        pb = ProgressBar(len(paths), enabled=progress)
        io_threads = io_threads or max(min(self.params.threads, 16), 1)
        read_ahead = read_ahead or max(8 * self.batch, 2 * io_threads)
        results: Dict[int, FileSketch] = {}
        timer = self._timer = SketchTimer(self.device)
        window = collections.deque()  # (input indices, handle), oldest first

        def finish(i: int, res: Dict[str, object]) -> None:
            with timer.stage("compress"):
                results[i] = self._to_filesketch(res, str(paths[i]))
            pb.inc()

        def drain_one() -> None:
            idxs, handle = window.popleft()
            for i, res in zip(idxs, self.collect_batch(handle)):
                finish(i, res)

        def run(group: List[Tuple[int, PackedGenome]]) -> None:
            window.append(([i for i, _ in group],
                           self.submit_batch_packed([g for _, g in group])))
            if len(window) >= pipeline_depth:
                drain_one()

        by_bucket: Dict[int, List[Tuple[int, PackedGenome]]] = {}
        pending = collections.deque()
        it = iter(range(len(paths)))
        pool = ThreadPoolExecutor(max_workers=io_threads)

        def fill():
            # "io_pool": submitting parses; the pool starts a thread at each
            # submit until it has io_threads
            with timer.stage("io_pool"):
                while len(pending) < read_ahead:
                    i = next(it, None)
                    if i is None:
                        return
                    pending.append((i, pool.submit(read_genome_packed, paths[i])))

        try:
            fill()
            while pending:
                i, fut = pending.popleft()
                with timer.stage("fasta_read"):
                    g = fut.result()
                fill()
                bucket = self._bucket(g.length)
                if bucket >= self.seqpar_min_chunks:
                    while window:
                        drain_one()
                    finish(i, self._sketch_huge(g))
                    continue
                by_bucket.setdefault(bucket, []).append((i, g))
                if len(by_bucket[bucket]) >= self.batch:
                    run(by_bucket.pop(bucket))
            for bucket in sorted(by_bucket):
                group = by_bucket[bucket]
                for j in range(0, len(group), self.batch):
                    run(group[j : j + self.batch])
            while window:
                drain_one()
        finally:
            with timer.stage("io_pool"):
                pool.shutdown(wait=True)
            self._timer = None
        pb.finish()
        timer.resolve()
        self.last_stage_times = dict(timer.totals)
        self.last_device_times = dict(timer.device_totals)
        if os.environ.get("HG_STAGE_TIMING"):
            log.info("sketch stage timing:\n%s", timer.report())
        return [results[i] for i in range(len(paths))]
