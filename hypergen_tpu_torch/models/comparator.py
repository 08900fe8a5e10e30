"""ANI comparator: tiled exact dots on the device, reference-exact TSV.

Counterpart of ``hypergen_tpu.models.comparator`` for ``dist``. The
all-pairs loop of the reference (reference:src/dist.rs:11-63) becomes tiled
matrix products; every printed ANI comes from the host float32 chain, so
the TSV is byte-identical to the JAX package's. The host-only functions
below are copies of the JAX module's, which imports jax at its top.
"""

from __future__ import annotations

import logging
from typing import List, Tuple

import numpy as np
import torch

from hypergen_tpu_torch.io.sketch_db import ShardedDB
from hypergen_tpu_torch.ops.ani import dot_i16_exact, dot_threshold_compact

log = logging.getLogger("hypergen")

_TSV_CHUNK_ROWS = 1 << 19


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


def _ani_host_pairs(
    dot: np.ndarray, norm2_r: np.ndarray, norm2_q: np.ndarray, ksize: int
) -> np.ndarray:
    """Exact host float32 ANI chain for flat pair vectors (not matrices)."""
    return _ani_chain(
        dot, norm2_r.astype(np.int32), norm2_q.astype(np.int32), ksize
    )


def _tile_below_diagonal(gi_min: int, gj_min: int, tn: int) -> bool:
    """True if a [tm x tn] tile at (gi_min, gj_min) has no i < j pair.

    Symmetric dist enumerates only j > i (reference:src/dist.rs:243-265),
    so such tiles are skipped before the matrix product.
    """
    return gi_min >= gj_min + tn - 1


class Comparator:
    """Tiled exact int32 dot matrices between sketch DBs on one device."""

    def __init__(self, ksize: int, device="cuda", tile_m: int = 2048,
                 tile_n: int = 2048):
        self.ksize = ksize
        self.device = torch.device(device)
        self.tile_m = tile_m
        self.tile_n = tile_n

    def _tiles(self, ref_db: ShardedDB, query_db: ShardedDB, symmetric: bool):
        """Yield (mi, nj, r_hv, r_norm, q_hv, q_norm) device tiles, query
        tiles outer so each crosses to the device once; tiles with no i < j
        pair are skipped in the symmetric case."""
        r_hv, r_norm = db_to_tensors(ref_db, self.device)
        q_hv, q_norm = (
            (r_hv, r_norm) if query_db is ref_db
            else db_to_tensors(query_db, self.device)
        )
        tm, tn = self.tile_m, self.tile_n
        for nj in range(0, q_hv.shape[0], tn):
            for mi in range(0, r_hv.shape[0], tm):
                if symmetric and _tile_below_diagonal(mi, nj, tn):
                    continue
                yield (mi, nj, r_hv[mi : mi + tm], r_norm[mi : mi + tm],
                       q_hv[nj : nj + tn], q_norm[nj : nj + tn])

    def ani_pairs_thresholded(
        self, ref_db: ShardedDB, query_db: ShardedDB, symmetric: bool,
        threshold: float,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """Pairs with ANI >= threshold, filtered on the device.

        Only the pairs that pass the device's margin-relaxed float32 test
        leave the device, with their exact dots; the host chain recomputes
        and re-filters them. Returns (ref_idx, query_idx, ani, n_total) in
        reference enumeration order (i, then j; j > i when symmetric).
        """
        out_i: List[np.ndarray] = []
        out_j: List[np.ndarray] = []
        out_a: List[np.ndarray] = []
        for mi, nj, r, nr, q, nq in self._tiles(ref_db, query_db, symmetric):
            idx, dot = dot_threshold_compact(
                r, nr, q, nq, threshold, self.ksize
            )
            idx, dot = idx.cpu().numpy(), dot.cpu().numpy()
            ii = mi + idx // q.shape[0]
            jj = nj + idx % q.shape[0]
            ani = _ani_host_pairs(
                dot, ref_db.norms[ii], query_db.norms[jj], self.ksize
            )
            keep = ani >= np.float32(threshold)
            out_i.append(ii[keep])
            out_j.append(jj[keep])
            out_a.append(ani[keep])
        return _finish_pairs(out_i, out_j, out_a, ref_db, query_db, symmetric)

    def ani_pairs_streamed(
        self, ref_db: ShardedDB, query_db: ShardedDB, symmetric: bool,
        threshold: float,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """Pairs with ANI >= threshold, filtered on the host per tile.

        For thresholds below the device filter's regime: each full dot tile
        comes to the host, and only its survivors are kept, so memory is
        O(survivors). Same returns as ani_pairs_thresholded.
        """
        out_i: List[np.ndarray] = []
        out_j: List[np.ndarray] = []
        out_a: List[np.ndarray] = []
        for mi, nj, r, _, q, _ in self._tiles(ref_db, query_db, symmetric):
            tile = dot_i16_exact(r, q).cpu().numpy()
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
        return _finish_pairs(out_i, out_j, out_a, ref_db, query_db, symmetric)


def _finish_pairs(out_i, out_j, out_a, ref_db, query_db, symmetric):
    """Concatenate tile survivors, keep j > i when symmetric, and restore
    the reference enumeration order (i, then j)."""
    ii = np.concatenate(out_i).astype(np.int64) if out_i else np.zeros(0, np.int64)
    jj = np.concatenate(out_j).astype(np.int64) if out_j else np.zeros(0, np.int64)
    aa = np.concatenate(out_a) if out_a else np.zeros(0, np.float32)
    M, N = len(ref_db.names), len(query_db.names)
    if symmetric:
        keep = ii < jj
        ii, jj, aa = ii[keep], jj[keep], aa[keep]
        n_total = M * (M - 1) // 2
    else:
        n_total = M * N
    order = np.lexsort((jj, ii))
    return ii[order], jj[order], aa[order], n_total


def write_ani_report(
    out_path,
    ref_names: List[str],
    query_names: List[str],
    ref_idx: np.ndarray,
    query_idx: np.ndarray,
    ani: np.ndarray,
    threshold: float,
) -> int:
    """Streamed reference-exact TSV writer; returns n_reported.

    Rows are stable-sorted by ANI ascending then reversed, cut at the
    threshold and printed '%.3f' (reference:src/utils.rs:260-290), in
    chunks of _TSV_CHUNK_ROWS to bound the formatted strings' memory.
    """
    ani = np.asarray(ani)
    # filter before sorting: NaN fails >= and would otherwise sort first in
    # descending order; a stable sort of a subsequence keeps tie order
    kept = np.flatnonzero(ani >= np.float32(threshold))
    order = kept[np.argsort(ani[kept], kind="stable")[::-1]]
    n_keep = kept.size
    names_r = np.char.add(np.asarray(ref_names, dtype=np.str_), "\t")
    names_q = np.char.add(np.asarray(query_names, dtype=np.str_), "\t")
    with open(out_path, "w") as fh:
        for lo in range(0, n_keep, _TSV_CHUNK_ROWS):
            sel = order[lo : lo + _TSV_CHUNK_ROWS]
            fh.write(_tsv_rows(
                names_r[ref_idx[sel]], names_q[query_idx[sel]], ani[sel]
            ))
    return n_keep


def _tsv_rows(ref_tab: np.ndarray, q_tab: np.ndarray,
              vals: np.ndarray) -> str:
    """Vectorized `ref\\tquery\\t%.3f\\n` assembly for gathered row arrays.

    np.char.mod routes the float32 through the same C '%.3f' double path
    as an f-string, so bytes equal the scalar formatter's."""
    return "".join(np.char.add(
        np.char.add(ref_tab, q_tab),
        np.char.add(np.char.mod("%.3f", vals), "\n"),
    ).tolist())


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
