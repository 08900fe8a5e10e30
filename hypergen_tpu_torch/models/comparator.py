"""ANI comparator: tiled exact dots on the device, reference-exact TSVs.

Counterpart of ``hypergen_tpu.models.comparator`` for `dist` and
`search`. The all-pairs loop of the reference (reference:src/dist.rs:11-63)
becomes tiled matrix products against a reference DB held on the device
split into int8 planes once (``preload_rows``); every printed ANI comes from
the host float32 chain, so the TSVs are byte-identical to the JAX package's.
The host-only functions below are copies of the JAX module's, which imports
jax at its top.

`dist`'s pair path is timed in the spans and counted in the counters of
``utils.timing``: ``dist_compare`` around a whole ``ani_pairs_thresholded``
or ``ani_pairs_streamed`` call, ``dist_preload`` around the row tiles'
upload, the read of their bound and their split, ``dist_fetch`` and
``dist_host_chain`` in each tile, ``dist_finish`` and ``dist_report``;
the counters ``dist_candidates`` and ``dist_kept``. The TSV rows of
`dist` and `search` are formatted by the native routine
``csrc/tsv_rows.cpp`` (rows counted in ``tsv_rows_native``) or, where it
cannot run, by ``np.char`` (``tsv_rows_fallback``).
"""

from __future__ import annotations

import ctypes
import functools
import locale
import logging
import subprocess
from typing import Iterator, List, Tuple

import numpy as np
import torch

from hypergen_tpu_torch.io.sketch_db import ShardedDB
from hypergen_tpu_torch.ops.ani import (
    SmallSplit, bound_on_device, dot_i16_any, dot_threshold_compact,
    presplit_rows, presplit_rows_small, resolve_mode,
)
from hypergen_tpu_torch.ops.kernels import build
from hypergen_tpu_torch.utils.timing import count, span

log = logging.getLogger("hypergen")


def db_to_tensors(db: ShardedDB, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A loaded DB's (hvs int16 [N, D], norms int32 [N]) on ``device``."""
    hvs = torch.from_numpy(np.ascontiguousarray(db.hvs, dtype=np.int16))
    norms = torch.from_numpy(np.ascontiguousarray(db.norms, dtype=np.int32))
    return hvs.to(device), norms.to(device)


def ani_f32_host(dot: np.ndarray, norm2_r: np.ndarray, norm2_q: np.ndarray,
                 ksize: int) -> np.ndarray:
    """Vectorized host float32 ANI%% map (reference:src/dist.rs:150-161).

    dot: int32 [m, n]; norm2_r: int32 [m]; norm2_q: int32 [n].
    Every op is an elementwise IEEE f32 op, matching the reference's scalar
    f32 evaluation order: J = dot/(nr+nq-dot); ANI = 1 + ln(2/(1/J+1))/k;
    NaN -> 0; clamp to [0,1]; *100.
    """
    return _ani_chain(
        dot, norm2_r[:, None].astype(np.int32),
        norm2_q[None, :].astype(np.int32), ksize,
    )


def _ani_chain(
    dot: np.ndarray, norm2_r: np.ndarray, norm2_q: np.ndarray, ksize: int
) -> np.ndarray:
    """The reference's scalar f32 chain on broadcastable int32 inputs.

    The denominator wraps in i32 exactly like the reference (numpy int32
    arithmetic is modular); every float op is an elementwise IEEE f32 op.
    """
    dot_f = dot.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        denom = (norm2_r + norm2_q - dot.astype(np.int32)).astype(np.float32)
        jaccard = dot_f / denom
        inner = np.float32(2.0) / (np.float32(1.0) / jaccard + np.float32(1.0))
        ani = np.float32(1.0) + np.log(inner) / np.float32(ksize)
    ani = np.where(np.isnan(ani), np.float32(0.0), ani)
    ani = np.clip(ani, np.float32(0.0), np.float32(1.0))
    return (ani * np.float32(100.0)).astype(np.float32)


def ani_host_pairs(
    dot: np.ndarray, norm2_r: np.ndarray, norm2_q: np.ndarray, ksize: int
) -> np.ndarray:
    """Exact host float32 ANI chain for flat pair vectors (not matrices)."""
    return _ani_chain(
        dot, norm2_r.astype(np.int32), norm2_q.astype(np.int32), ksize
    )


def _tile_below_diagonal(gi_min: int, gj_min: int, tn: int) -> bool:
    """True if a [tm x tn] tile at global (gi_min, gj_min) has no i < j pair.

    Symmetric dist enumerates only j > i (reference:src/dist.rs:243-265),
    so such tiles are skipped before the matrix product.
    """
    return gi_min >= gj_min + tn - 1


class Comparator:
    """Tiled exact int32 dot matrices between sketch DBs on one device.

    mode: the dot mode of ``ops.ani`` (None: the int8 split on a CUDA
    device, upgraded to "small" where the resident rows and a query tile
    fit, as read from their bytes on the device; the direct dot on the
    CPU)."""

    # dense all-pairs is an exhaustive-table utility (tests, small sets);
    # above this it would allocate multi-GB host float matrices
    MAX_DENSE_PAIRS = 1 << 25

    def __init__(self, ksize: int, device="cuda", tile_m: int = 2048,
                 tile_n: int = 2048, mode=None):
        self.ksize = ksize
        self.device = torch.device(device)
        self.tile_m = tile_m
        self.tile_n = tile_n
        self.mode = self.device.type == "cuda" if mode is None else mode

    def dot_mode(self, *hv_arrays):
        """The mode for these operands (ops.ani.resolve_mode): the 3-product
        split when self.mode is True and every HV value fits
        SMALL_SPLIT_MAX."""
        return resolve_mode(self.mode, self.device, *hv_arrays)

    def _query_mode(self, tile, q: torch.Tensor, own: bool):
        """The mode of products of resident row tiles like ``tile`` with
        the query tile q on the device: "small" only when they are
        SmallSplit (self.mode is True and the reference fit when it was
        preloaded) and q fits, read from q's bytes on the device unless q
        holds the reference's own rows (own: a symmetric call). Other
        tiles keep self.mode."""
        if not isinstance(tile, SmallSplit):
            return self.mode
        return "small" if own else self.dot_mode(q)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def preload_rows(self, hv: np.ndarray) -> List:
        """Row tiles uploaded once, for reuse across query tiles (in the
        span dist_preload).

        With an int8 mode the tiles are stored split: SmallSplit (h, l,
        h + l) when the rows fit SMALL_SPLIT_MAX, else (hi, lo, row); the
        elementwise split then never repeats per query tile. An over-bound
        query batch against SmallSplit tiles rebuilds the exact rows
        (dot_i16_any)."""
        with span("dist_preload"):
            return self._row_tiles(hv)

    def _row_tiles(self, hv: np.ndarray) -> List:
        """The tiles uploaded unsplit, each one's bound reduced on the
        device as it lands, and the largest read with one host read after
        the last upload (self.mode True); then every tile split in the one
        mode, each int16 tile freed as its planes are made."""
        tm = self.tile_m
        tiles, bounds = [], []
        for mi in range(0, hv.shape[0], tm):
            tiles.append(self._upload(hv[mi : mi + tm]))
            if self.mode is True:
                bounds.append(bound_on_device(tiles[-1]))
        # the bounds are >= 0, so their own bound is the largest
        small = bool(bounds) and self.dot_mode(torch.stack(bounds)) == "small"
        out = []
        while tiles:
            t = tiles.pop(0)
            if small:
                t = presplit_rows_small(t)
            elif self.mode:
                t = presplit_rows(t)
            out.append(t)
        return out

    def preload_ref(self, db: ShardedDB) -> List:
        """Device-resident (hv, norm) row tiles for ani_pairs_thresholded;
        hv tiles as preload_rows stores them (in the span dist_preload)."""
        tm = self.tile_m
        with span("dist_preload"):
            return [
                (hv, self._upload(db.norms[mi : mi + tm]))
                for hv, mi in zip(self._row_tiles(db.hvs),
                                  range(0, db.hvs.shape[0], tm))
            ]

    def dot_tiles(
        self, r_hv: np.ndarray, q_hv: np.ndarray, r_blocks: List | None = None,
    ) -> Iterator[Tuple[int, int, np.ndarray]]:
        """Yield (row_offset, col_offset, int32 dot tile), row tiles outer.

        r_blocks: optional device-resident row tiles from preload_rows."""
        if r_blocks is None:
            r_blocks = self.preload_rows(r_hv)
        tn = self.tile_n
        for r_dev, mi in zip(r_blocks, range(0, r_hv.shape[0], self.tile_m)):
            for nj in range(0, q_hv.shape[0], tn):
                q = self._upload(q_hv[nj : nj + tn])
                mode = self._query_mode(r_dev, q, q_hv is r_hv)
                yield mi, nj, dot_i16_any(r_dev, q, mode).cpu().numpy()

    def ani_pairs(
        self, ref_db: ShardedDB, query_db: ShardedDB, symmetric: bool,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All pair ANIs in reference enumeration order: i over refs, j over
        queries, j > i when symmetric (reference:src/dist.rs:252-265).

        Refused past MAX_DENSE_PAIRS (the dense M x N host matrix); the
        streamed path returns identical ANIs with O(survivors) memory."""
        M, N = ref_db.hvs.shape[0], query_db.hvs.shape[0]
        if symmetric and N != M:
            raise ValueError("symmetric dist requires square pair matrix")
        if M * N > self.MAX_DENSE_PAIRS:
            raise ValueError(
                f"ani_pairs would materialize {M}x{N} = {M * N} host floats "
                f"(> MAX_DENSE_PAIRS={self.MAX_DENSE_PAIRS}); use "
                "ani_pairs_streamed(threshold=...) which keeps only "
                "survivors and returns identical ANI values"
            )
        ani_full = np.zeros((M, N), dtype=np.float32)
        for mi, nj, tile in self.dot_tiles(ref_db.hvs, query_db.hvs):
            m, n = tile.shape
            ani_full[mi : mi + m, nj : nj + n] = ani_f32_host(
                tile, ref_db.norms[mi : mi + m], query_db.norms[nj : nj + n],
                self.ksize,
            )
        if symmetric:
            ii, jj = np.triu_indices(M, k=1)
        else:
            ii, jj = np.meshgrid(np.arange(M), np.arange(N), indexing="ij")
            ii, jj = ii.ravel(), jj.ravel()
        return ii.astype(np.int64), jj.astype(np.int64), ani_full[ii, jj]

    def _query_tiles(self, ref_db: ShardedDB, query_db: ShardedDB,
                     tile, symmetric: bool, ref_offset: int,
                     query_offset: int):
        """Yield (nj, query tile on the device, its mode against resident
        row tiles like ``tile`` (_query_mode), [(bi, mi), ...]): query
        tiles outer, so each crosses to the device once, and the row tiles
        that hold an i < j pair (global indices) when symmetric."""
        tm, tn = self.tile_m, self.tile_n
        own = query_db.hvs is ref_db.hvs
        for nj in range(0, query_db.hvs.shape[0], tn):
            rows = [
                (bi, mi) for bi, mi in enumerate(range(0, ref_db.hvs.shape[0],
                                                       tm))
                if not (symmetric and _tile_below_diagonal(
                    mi + ref_offset, nj + query_offset, tn))
            ]
            q = self._upload(query_db.hvs[nj : nj + tn])
            yield nj, q, self._query_mode(tile, q, own), rows

    def ani_pairs_thresholded(
        self, ref_db: ShardedDB, query_db: ShardedDB, symmetric: bool,
        threshold: float, ref_blocks: List | None = None,
        ref_offset: int = 0, query_offset: int = 0,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """Pairs with ANI >= threshold, filtered on the device.

        Only the pairs that pass the device's margin-relaxed float32 test
        leave the device, with their exact dots; the host chain recomputes
        and re-filters them. Returns (ref_idx, query_idx, ani, n_total) in
        reference enumeration order (i, then j; j > i when symmetric).
        ref_blocks: device-resident blocks from preload_ref. ref_offset /
        query_offset: global row / column of this rectangle (a pod's part);
        the symmetric filter and the tile skip use global indices, the
        returned indices stay local, and n_total is only meaningful at zero
        offsets.
        """
        with span("dist_compare"):
            M = ref_db.hvs.shape[0]
            if ref_blocks is None:
                ref_blocks = self.preload_ref(ref_db)
            out_i: List[np.ndarray] = []
            out_j: List[np.ndarray] = []
            out_a: List[np.ndarray] = []
            for nj, q, mode, rows in self._query_tiles(
                    ref_db, query_db, ref_blocks[0][0] if ref_blocks else None,
                    symmetric, ref_offset, query_offset):
                n = q.shape[0]
                nq = self._upload(query_db.norms[nj : nj + n])
                for bi, mi in rows:
                    r, nr = ref_blocks[bi]
                    idx, dot = dot_threshold_compact(
                        r, nr, q, nq, threshold, self.ksize, mode
                    )
                    with span("dist_fetch"):
                        idx, dot = idx.cpu().numpy(), dot.cpu().numpy()
                    count("dist_candidates", idx.size)
                    with span("dist_host_chain"):
                        ii, jj = mi + idx // n, nj + idx % n
                        ani = ani_host_pairs(
                            dot, ref_db.norms[ii], query_db.norms[jj],
                            self.ksize
                        )
                        keep = ani >= np.float32(threshold)
                        out_i.append(ii[keep])
                        out_j.append(jj[keep])
                        out_a.append(ani[keep])
            return _finish_pairs(out_i, out_j, out_a, M,
                                 query_db.hvs.shape[0], symmetric,
                                 ref_offset, query_offset)

    def ani_pairs_streamed(
        self, ref_db: ShardedDB, query_db: ShardedDB, symmetric: bool,
        threshold: float, ref_offset: int = 0, query_offset: int = 0,
        ref_blocks: List | None = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """Pairs with ANI >= threshold, filtered on the host per tile.

        For thresholds below the device filter's regime: each full dot tile
        comes to the host, and only its survivors are kept, so memory is
        O(survivors). ref_blocks from preload_rows; same returns and offset
        semantics as ani_pairs_thresholded.
        """
        with span("dist_compare"):
            M = ref_db.hvs.shape[0]
            if ref_blocks is None:
                ref_blocks = self.preload_rows(ref_db.hvs)
            out_i: List[np.ndarray] = []
            out_j: List[np.ndarray] = []
            out_a: List[np.ndarray] = []
            for nj, q, mode, rows in self._query_tiles(
                    ref_db, query_db, ref_blocks[0] if ref_blocks else None,
                    symmetric, ref_offset, query_offset):
                for bi, mi in rows:
                    tile = dot_i16_any(ref_blocks[bi], q, mode)
                    with span("dist_fetch"):
                        tile = tile.cpu().numpy()
                    count("dist_candidates", tile.size)
                    with span("dist_host_chain"):
                        ani = ani_f32_host(
                            tile,
                            ref_db.norms[mi : mi + tile.shape[0]],
                            query_db.norms[nj : nj + tile.shape[1]],
                            self.ksize,
                        )
                        ri, qi = np.nonzero(ani >= np.float32(threshold))
                        out_i.append((mi + ri).astype(np.int64))
                        out_j.append((nj + qi).astype(np.int64))
                        out_a.append(ani[ri, qi])
            return _finish_pairs(out_i, out_j, out_a, M,
                                 query_db.hvs.shape[0], symmetric,
                                 ref_offset, query_offset)


def _finish_pairs(out_i, out_j, out_a, M: int, N: int, symmetric: bool,
                  ref_offset: int, query_offset: int):
    """Concatenate tile survivors, keep global j > i when symmetric, and
    restore the reference enumeration order (i, then j); in the span
    dist_finish, the pairs kept counted in dist_kept."""
    with span("dist_finish"):
        ii = (np.concatenate(out_i).astype(np.int64) if out_i
              else np.zeros(0, np.int64))
        jj = (np.concatenate(out_j).astype(np.int64) if out_j
              else np.zeros(0, np.int64))
        aa = np.concatenate(out_a) if out_a else np.zeros(0, np.float32)
        if symmetric:
            keep = (ii + ref_offset) < (jj + query_offset)
            ii, jj, aa = ii[keep], jj[keep], aa[keep]
            n_total = M * (M - 1) // 2
        else:
            n_total = M * N
        count("dist_kept", ii.size)
        order = np.lexsort((jj, ii))
        return ii[order], jj[order], aa[order], n_total


def format_ani_report(
    ref_names: List[str],
    query_names: List[str],
    ref_idx: np.ndarray,
    query_idx: np.ndarray,
    ani: np.ndarray,
    threshold: float,
    top_k: int = 0,
) -> Tuple[str, int]:
    """Reference-exact TSV: sort desc (stable ties reversed), filter, format.

    Mirrors reference:src/utils.rs:260-290: indices stable-sorted ascending
    by ANI then reversed, rows emitted while ani >= threshold, '%.3f'.
    Returns (tsv_string, n_reported). top_k > 0 additionally caps the rows.
    NaN ANIs are dropped up front (the reference's sort panics on them).
    """
    ani = np.asarray(ani)
    kept = np.flatnonzero(~np.isnan(ani))
    order = kept[np.argsort(ani[kept], kind="stable")[::-1]]
    lines = []
    thr = np.float32(threshold)
    for idx in order:
        if not ani[idx] >= thr:
            break
        lines.append(
            f"{ref_names[int(ref_idx[idx])]}\t"
            f"{query_names[int(query_idx[idx])]}\t"
            f"{ani[idx]:.3f}\n"
        )
        if top_k and len(lines) >= top_k:
            break
    return "".join(lines), len(lines)


def write_ani_report(
    out_path,
    ref_names: List[str],
    query_names: List[str],
    ref_idx: np.ndarray,
    query_idx: np.ndarray,
    ani: np.ndarray,
    threshold: float,
    top_k: int = 0,
    chunk_rows: int = 1 << 19,
) -> int:
    """Streamed reference-exact TSV writer; returns n_reported.

    Rows are stable-sorted by ANI ascending then reversed, cut at the
    threshold (and at top_k rows when given) and printed '%.3f'
    (reference:src/utils.rs:260-290), in chunks of chunk_rows to bound the
    formatted rows' memory (_TsvWriter). Byte-identical to
    format_ani_report. In the span dist_report.
    """
    with span("dist_report"):
        ani = np.asarray(ani)
        # filter before sorting: NaN fails >= and would otherwise sort first
        # in descending order; a stable sort of a subsequence keeps tie order
        kept = np.flatnonzero(ani >= np.float32(threshold))
        order = kept[np.argsort(ani[kept], kind="stable")[::-1]]
        n_keep = min(kept.size, top_k) if top_k else kept.size
        with _TsvWriter(out_path, ref_names, query_names) as w:
            for lo in range(0, n_keep, chunk_rows):
                sel = order[lo : min(lo + chunk_rows, n_keep)]
                w.write(ref_idx[sel], query_idx[sel], ani[sel])
        return n_keep


@functools.lru_cache(maxsize=None)
def _tsv_lib():
    """The native row formatter (``csrc/tsv_rows.cpp``), built at first use;
    None where it cannot be built or loaded: the reports then take the
    np.char path (_tsv_rows)."""
    try:
        lib = build.load("tsv_rows")
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        log.warning("native TSV row formatter unavailable, rows go through "
                    "numpy: %s", e)
        return None
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.hg_tsv_capacity.restype = ll
    lib.hg_tsv_capacity.argtypes = [vp, ll, vp, ll, vp, vp, vp, ll]
    lib.hg_tsv_rows.restype = ll
    lib.hg_tsv_rows.argtypes = [vp, vp, vp, vp, vp, vp, vp, ll, vp]
    return lib


def _encode_names(names, encoding: str) -> Tuple[np.ndarray, np.ndarray]:
    """(bytes uint8 [B], offsets int64 [n + 1]) of each name followed by
    its tab, encoded strictly in `encoding` (ASCII text as ASCII)."""
    text = "\t".join(names) + "\t"
    if text.isascii():
        data = text.encode("ascii")
        lens = np.fromiter(map(len, names), np.int64, len(names)) + 1
    else:
        parts = [(name + "\t").encode(encoding) for name in names]
        data = b"".join(parts)
        lens = np.fromiter(map(len, parts), np.int64, len(parts))
    off = np.zeros(len(names) + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    return np.frombuffer(data, np.uint8), off


def _native_rows(lib, names_r, names_q, ref_idx, query_idx,
                 vals) -> np.ndarray | None:
    """The rows' bytes (uint8) from the native formatter, or None where it
    refuses them: an index outside its names, a value that is not a
    float32 in [0, 1000) (NaN, inf and -0.0 included)."""
    vals = np.asarray(vals)
    if vals.dtype != np.float32:
        return None
    v = np.ascontiguousarray(vals)
    ri = np.ascontiguousarray(ref_idx, dtype=np.int64)
    qi = np.ascontiguousarray(query_idx, dtype=np.int64)
    n = v.size
    if not ri.shape == qi.shape == v.shape == (n,):
        raise ValueError(f"row arrays of shapes {ri.shape}, {qi.shape}, "
                         f"{v.shape}: want three of ({n},)")
    (rb, ro), (qb, qo) = names_r, names_q
    cap = lib.hg_tsv_capacity(ro.ctypes.data, ro.size - 1, qo.ctypes.data,
                              qo.size - 1, ri.ctypes.data, qi.ctypes.data,
                              v.ctypes.data, n)
    if cap < 0:
        return None
    out = np.empty(cap, np.uint8)
    written = lib.hg_tsv_rows(rb.ctypes.data, ro.ctypes.data, qb.ctypes.data,
                              qo.ctypes.data, ri.ctypes.data, qi.ctypes.data,
                              v.ctypes.data, n, out.ctypes.data)
    return out[:written]


class _TsvWriter:
    """One report's file, to which ``write`` appends rows
    `ref\\tquery\\t%.3f\\n`: the one home of the row format for `dist`
    and `search`.

    The native formatter (``csrc/tsv_rows.cpp``) writes a call's rows into
    one byte buffer, written to the file in binary; the names are encoded
    once a report (once for both sides when ``query_names is
    ref_names``) with the codec of ``open(path, "w")``,
    ``locale.getpreferredencoding(False)``, strict. A call whose rows it
    refuses takes the np.char path (_tsv_rows), as every call does where
    the library cannot be loaded or the names cannot be encoded. The
    formatter writes its digits, tabs and newlines as ASCII, as every
    locale codec does. Rows are counted in ``tsv_rows_native`` and
    ``tsv_rows_fallback``.
    """

    def __init__(self, out_path, ref_names, query_names):
        self.ref_names, self.query_names = ref_names, query_names
        self.encoding = locale.getpreferredencoding(False)
        self.lib = _tsv_lib()
        self.names = None
        if self.lib is not None:
            try:
                r = _encode_names(ref_names, self.encoding)
                q = (r if query_names is ref_names
                     else _encode_names(query_names, self.encoding))
                self.names = (r, q)
            except (TypeError, UnicodeEncodeError):
                pass  # a name np.char converts, or one the rows may not use
        self.fh = open(out_path, "w" if self.names is None else "wb")

    def __enter__(self) -> "_TsvWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.fh.close()

    @functools.cached_property
    def _tabbed(self) -> Tuple[np.ndarray, np.ndarray]:
        return (np.char.add(np.asarray(self.ref_names, dtype=np.str_), "\t"),
                np.char.add(np.asarray(self.query_names, dtype=np.str_),
                            "\t"))

    def write(self, ref_idx: np.ndarray, query_idx: np.ndarray,
              vals: np.ndarray) -> None:
        """Append the rows of these gathered index and value arrays."""
        if self.names is not None:
            buf = _native_rows(self.lib, *self.names, ref_idx, query_idx,
                               vals)
            if buf is not None:
                self.fh.write(buf)
                count("tsv_rows_native", len(vals))
                return
        names_r, names_q = self._tabbed
        text = _tsv_rows(names_r[ref_idx], names_q[query_idx], vals)
        self.fh.write(text if self.names is None
                      else text.encode(self.encoding))
        count("tsv_rows_fallback", len(vals))


def _tsv_rows(ref_tab: np.ndarray, q_tab: np.ndarray,
              vals: np.ndarray) -> str:
    """Vectorized `ref\\tquery\\t%.3f\\n` assembly for gathered row arrays,
    where the native formatter cannot run (_TsvWriter).

    np.char.mod routes the float32 through the same C '%.3f' double path
    as an f-string, so bytes equal the scalar formatter's."""
    return "".join(np.char.add(
        np.char.add(ref_tab, q_tab),
        np.char.add(np.char.mod("%.3f", vals), "\n"),
    ).tolist())


def write_search_report(
    out_path,
    ref_names: List[str],
    query_names: List[str],
    ref_idx: np.ndarray,
    ani: np.ndarray,
    threshold: float,
    chunk_queries: int = 4096,
) -> int:
    """Streamed search TSV: per-query top-k blocks, queries in input order.

    ref_idx/ani are [N_queries, k_top]. Within each query the rows are
    stable-sorted descending by ANI with ties reversed and cut at the
    threshold: format_ani_report applied per query (reference:src/utils.rs:
    262-286), written in chunks of queries (_TsvWriter). NaN ANIs (empty
    slots) never emit. Returns n_reported.
    """
    a = np.ascontiguousarray(np.asarray(ani, dtype=np.float32))
    idx = np.asarray(ref_idx)
    if a.ndim != 2:
        raise ValueError("ani must be [n_queries, k_top]")
    N = a.shape[0]
    # ascending stable argsort reversed = descending with ties reversed;
    # NaN sorts last ascending -> first reversed, and the >= threshold mask
    # drops it, so survivors form the subsequence format_ani_report emits
    ordc = np.argsort(a, axis=1, kind="stable")[:, ::-1]
    a_sorted = np.take_along_axis(a, ordc, axis=1)
    keep = a_sorted >= np.float32(threshold)
    idx_sorted = np.take_along_axis(idx, ordc, axis=1)
    n = 0
    with _TsvWriter(out_path, ref_names, query_names) as w:
        for lo in range(0, N, chunk_queries):
            hi = min(lo + chunk_queries, N)
            qi, ci = np.nonzero(keep[lo:hi])
            if qi.size == 0:
                continue
            w.write(idx_sorted[lo:hi][qi, ci], qi + lo,
                    a_sorted[lo:hi][qi, ci])
            n += int(qi.size)
    return n


def count_search_hits(ani: np.ndarray, threshold: float) -> int:
    """Rows write_search_report would emit (for ranks that do not write)."""
    a = np.asarray(ani, dtype=np.float32)
    return int(np.sum(a >= np.float32(threshold)))


def report_sparsity(n_reported: int, n_total: int, threshold: float) -> None:
    """Warn when <5%% of pairs pass (reference:src/utils.rs:292-307)."""
    perc = n_reported / n_total * 100.0 if n_total else 0.0
    if perc < 5.0:
        log.warning(
            "Output ANIs with threshold %.1f are too divergent: %d of %d "
            "(%.2f%%) ANIs are reported",
            threshold, n_reported, n_total, perc,
        )
    else:
        log.info(
            "Output %d of %d ANIs above threshold %.1f",
            n_reported, n_total, threshold,
        )
