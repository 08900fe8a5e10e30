"""Plain reference of HyperGen's database search, in PyTorch and NumPy.

What ``search -r DB -q Q --top_k K -a A`` prints, written out here and
importing nothing of the program:

- the dot of two int16 HVs accumulates in a wrapping i32 (src/dist.rs);
  here exactly, in float64 (every partial sum is an integer below 2^53),
  then wrapped;
- each query ranks every database row by the device's float32 ANI, values
  descending and the lower row first among equal values, and keeps K;
- each kept pair's ANI is printed from the host float32 chain on its exact
  dot (src/dist.rs:150-161): J = dot / (n_r + n_q - dot) with the
  denominator wrapping in i32, ANI = 1 + ln(2 / (1/J + 1)) / k, NaN as 0,
  clamped to [0, 1], times 100;
- within a query the rows are sorted by that ANI, descending with ties in
  reverse order, cut below A, and printed as ``ref\\tquery\\t%.3f``.

The device float32 chain repeats the program's order of operations, so
that the rank of two rows a few ulps apart is the same on both sides.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int64) & 0xFFFFFFFF
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def narrow(hv: torch.Tensor, bits: int) -> torch.Tensor:
    """HVs wrapped to ``bits`` bits (16: unchanged)."""
    if bits >= 16:
        return hv
    half = 1 << (bits - 1)
    return (((hv.to(torch.int32) + half) & ((1 << bits) - 1)) - half).to(
        torch.int16)


def exact_dot(r: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """int32 [m, n] dots of int16 rows r [m, D] and q [n, D]."""
    d = torch.matmul(r.to(torch.float64), q.to(torch.float64).T)
    return wrap_i32(d.to(torch.int64))


def device_ani(dot: torch.Tensor, nr: torch.Tensor, nq: torch.Tensor,
               k: int) -> torch.Tensor:
    """The float32 ANI that ranks pairs, [m, n]."""
    den = nr.to(torch.int32)[:, None] + nq.to(torch.int32)[None, :]
    den -= dot
    ani = dot.to(torch.float32)
    ani /= den
    ani.reciprocal_().add_(1.0)
    torch.div(ani.new_tensor(2.0), ani, out=ani)
    ani.log_().div_(k).add_(1.0)
    ani.masked_fill_(ani.isnan(), 0.0)
    return ani.clamp_(0.0, 1.0).mul_(100.0)


def order_keys(ani: torch.Tensor, row0: int, m_total: int) -> torch.Tensor:
    """int64 keys whose descending order is ANI descending, then the lower
    row first: the float's order as a signed int in the high half, m_total
    - 1 - row in the low half. ani: [n, t] for rows row0 .. row0 + t."""
    b = ani.contiguous().view(torch.int32).to(torch.int64)
    b = torch.where(b < 0, b ^ 0x7FFFFFFF, b)
    rows = torch.arange(row0, row0 + ani.shape[1], device=ani.device)
    return (b << 32) + (m_total - 1 - rows)


def host_ani(dot: np.ndarray, nr: np.ndarray, nq: np.ndarray, k: int
             ) -> np.ndarray:
    """The printed ANI: HyperGen's scalar float32 chain, elementwise."""
    dot = dot.astype(np.int32)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        den = (nr.astype(np.int32) + nq.astype(np.int32) - dot).astype(
            np.float32)
        j = dot.astype(np.float32) / den
        inner = np.float32(2.0) / (np.float32(1.0) / j + np.float32(1.0))
        ani = np.float32(1.0) + np.log(inner) / np.float32(k)
    ani = np.where(np.isnan(ani), np.float32(0.0), ani)
    ani = np.clip(ani, np.float32(0.0), np.float32(1.0))
    return (ani * np.float32(100.0)).astype(np.float32)


def search_tsv(db_hv: np.ndarray, db_norm: np.ndarray, db_names: List[str],
               q_hv: np.ndarray, q_norm: np.ndarray, q_names: List[str],
               k: int, k_top: int, threshold: float, device,
               hv_bits: int = 16, tile: int = 8192) -> List[str]:
    """The search's TSV lines. hv_bits: the HVs' width (16 as HyperGen
    states it; the control's lower precision takes 8, norms recomputed)."""
    M, N = db_hv.shape[0], q_hv.shape[0]
    k_top = min(k_top, M)
    q = narrow(torch.from_numpy(q_hv).to(device), hv_bits)
    nq = torch.from_numpy(q_norm).to(device)
    if hv_bits < 16:
        nq = wrap_i32((q.to(torch.int64) ** 2).sum(-1))
    best = torch.full((N, k_top), -(2**63), dtype=torch.int64, device=device)
    for lo in range(0, M, tile):
        r = narrow(torch.from_numpy(db_hv[lo : lo + tile]).to(device), hv_bits)
        nr = torch.from_numpy(db_norm[lo : lo + tile]).to(device)
        if hv_bits < 16:
            nr = wrap_i32((r.to(torch.int64) ** 2).sum(-1))
        ani = device_ani(exact_dot(r, q), nr, nq, k)
        keys = order_keys(ani.T, lo, M)
        best = torch.topk(torch.cat([best, keys], 1), k_top, dim=1).values
    rows = (M - 1 - (best & 0xFFFFFFFF)).cpu().numpy()
    # each winner's exact dot, one query block at a time
    dots = np.empty((N, k_top), np.int32)
    norms_r = np.empty((N, k_top), np.int32)
    for lo in range(0, N, 512):
        sel = rows[lo : lo + 512]
        r = narrow(torch.from_numpy(db_hv[sel.ravel()]).to(device), hv_bits)
        r = r.to(torch.int64).view(sel.shape[0], k_top, -1)
        qq = q[lo : lo + 512].to(torch.int64)[:, None, :]
        dots[lo : lo + 512] = wrap_i32((r * qq).sum(-1)).cpu().numpy()
        if hv_bits < 16:
            norms_r[lo : lo + 512] = wrap_i32((r * r).sum(-1)).cpu().numpy()
        else:
            norms_r[lo : lo + 512] = db_norm[sel]
    ani = host_ani(dots, norms_r, nq.cpu().numpy()[:, None], k)
    thr = np.float32(threshold)
    lines = []
    for i in range(N):
        order = np.argsort(ani[i], kind="stable")[::-1]
        for j in order:
            if np.isnan(ani[i, j]):
                continue
            if not ani[i, j] >= thr:
                break
            lines.append(f"{db_names[rows[i, j]]}\t{q_names[i]}\t"
                         f"{ani[i, j]:.3f}\n")
    return lines
