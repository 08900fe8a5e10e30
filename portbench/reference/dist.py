"""Plain reference of HyperGen's all-pairs `dist` of one collection against
itself, in PyTorch and NumPy.

What ``dist -r C -q C -a A`` prints, written out here and importing nothing
of the program:

- the dot of two int16 HVs accumulates in a wrapping i32 (src/dist.rs); here
  exactly, in float64 blocks on the given device (|v| <= 2^15 and D < 2^23
  keep every partial sum an integer below 2^53 in any order), then wrapped;
- a float64 ANI on each exact dot screens the pairs: those at
  A - SCREEN_MARGIN or above, and those on which the screen cannot stand
  (below), go on as candidates;
- each candidate's printed ANI is HyperGen's scalar float32 chain on its
  exact dot (src/dist.rs:150-161, ``host_ani``): J = dot / (n_r + n_q - dot)
  with the denominator wrapping in i32, ANI = 1 + ln(2 / (1/J + 1)) / k,
  NaN as 0, clamped to [0, 1], times 100;
- the pairs i < j at A or above, in the order (i, then j), are sorted
  stably ascending by that ANI and reversed (src/utils.rs:260-290), and
  printed as ``ref\\tquery\\t%.3f``.

Why SCREEN_MARGIN (0.01 ANI %) covers every pair whose float32 chain
reaches A. Where the denominator is positive and J > -1/2, the chain has no
pole: for J >= 0 each of its steps (two int-to-float roundings, the
division, the reciprocal, the sum of two positives, 2/x, the log, /k, +1,
*100) adds at most a few units of float32 rounding (2^-24 relative) to a
value of order 1, so the float32 ANI % lies within 1e-4 of the exact one,
and the float64 screen is exact to far below that; for -1/2 < J < 0,
1/J + 1 < -1 on both sides, so both give NaN, then 0. The screen's margin
is a hundred times the float32 chain's error. Pairs outside that domain
(denominator <= 0, or J <= -1/2, where 1/J + 1 may cross 0 between the two
precisions) all go to the float32 chain; rows whose norms do not wrap
never give one (by Cauchy-Schwarz, J >= -1/3 and the denominator is
positive).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

# host_ani: the scalar float32 chain of src/dist.rs:150-161, which `dist`
# prints as `search` does
from .search import exact_dot, host_ani, narrow, wrap_i32

SCREEN_MARGIN = 0.01


def screen(dot: torch.Tensor, nr: torch.Tensor, nq: torch.Tensor, k: int,
           threshold: float) -> torch.Tensor:
    """bool [m, n]: the pairs whose float32 chain may reach threshold."""
    den = wrap_i32(nr.to(torch.int64)[:, None] + nq.to(torch.int64)[None, :]
                   - dot.to(torch.int64)).to(torch.float64)
    d = dot.to(torch.float64)
    ani = 1.0 + torch.log(2.0 / (den / d + 1.0)) / k
    ani = torch.nan_to_num(ani, nan=0.0).clamp(0.0, 1.0) * 100.0
    outside = (den <= 0) | (2.0 * d <= -den)
    return (ani >= threshold - SCREEN_MARGIN) | outside


def dist_tsv(hv: np.ndarray, norm: np.ndarray, names: List[str], k: int,
             threshold: float, device, hv_bits: int = 16,
             tile: int = 4096) -> List[str]:
    """The TSV lines of ``dist -r C -q C -a threshold`` over the rows of C.
    hv_bits: the HVs' width (16 as HyperGen states it; the control's lower
    precision takes 8, norms recomputed)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    M = hv.shape[0]
    x = narrow(torch.from_numpy(hv).to(device), hv_bits)
    n2 = torch.from_numpy(norm).to(device)
    if hv_bits < 16:
        n2 = wrap_i32((x.to(torch.int64) ** 2).sum(-1))
    ii, jj, dots = [], [], []
    for lo in range(0, M, tile):
        r = x[lo : lo + tile]
        for qlo in range(lo, M, tile):  # blocks that hold an i < j pair
            q = x[qlo : qlo + tile]
            dot = exact_dot(r, q)
            keep = screen(dot, n2[lo : lo + tile], n2[qlo : qlo + tile], k,
                          threshold)
            i = torch.arange(lo, lo + r.shape[0], device=device)[:, None]
            j = torch.arange(qlo, qlo + q.shape[0], device=device)[None, :]
            ri, qi = torch.nonzero(keep & (i < j), as_tuple=True)
            ii.append((ri + lo).cpu().numpy())
            jj.append((qi + qlo).cpu().numpy())
            dots.append(dot[ri, qi].cpu().numpy())
    ii, jj, dots = np.concatenate(ii), np.concatenate(jj), np.concatenate(dots)
    n2 = n2.cpu().numpy()
    ani = host_ani(dots, n2[ii], n2[jj], k)
    kept = ani >= np.float32(threshold)
    ii, jj, ani = ii[kept], jj[kept], ani[kept]
    enum = np.lexsort((jj, ii))
    order = enum[np.argsort(ani[enum], kind="stable")[::-1]]
    return [f"{names[ii[p]]}\t{names[jj[p]]}\t{ani[p]:.3f}\n" for p in order]
