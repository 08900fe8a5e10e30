"""ANI estimation from exact int16 HV dot products.

Counterpart of ``hypergen_tpu.ops.ani``. The reference accumulates
i16*i16 products into a wrapping i32 (reference:src/dist.rs:146-151). Here
the dot runs as a float64 matrix product: |v| <= 2^15 and D < 2^23 keep
every partial sum an exact integer below 2^53 in any summation order, and
the result is then wrapped to int32 mod 2^32. The int8 tensor-core split of
the JAX package's MXU path is later work.

The device float32 ANI map only filters pairs with a margin; every printed
value comes from the host float32 chain in ``models.comparator``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from hypergen_tpu_torch.ops.u64 import wrap_i32


def dot_i16_exact(r: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Int32 [M, N] dot matrix of int16 HVs r [M, D], q [N, D], bit-exact
    (mod 2^32) against a wrapping i32 accumulation."""
    d = torch.matmul(r.to(torch.float64), q.to(torch.float64).T)
    return wrap_i32(d.to(torch.int64))


def ani_from_dot_matrix(
    dot: torch.Tensor, norm2_r: torch.Tensor, norm2_q: torch.Tensor,
    ksize: int,
) -> torch.Tensor:
    """float32 ANI%% matrix (reference:src/dist.rs:150-161).

    dot: int32 [M, N]; norm2_r: int32 [M]; norm2_q: int32 [N]. The
    denominator wraps in i32 as the reference's does. NaN -> 0, clamp to
    [0, 1], times 100. May differ from the host chain in the last float
    bits, which the threshold margin of dot_threshold_compact covers.
    """
    denom = wrap_i32(
        norm2_r[:, None].to(torch.int64) + norm2_q[None, :].to(torch.int64)
        - dot.to(torch.int64)
    ).to(torch.float32)
    jaccard = dot.to(torch.float32) / denom
    inner = 2.0 / (1.0 / jaccard + 1.0)
    ani = 1.0 + torch.log(inner) / ksize
    ani = torch.where(torch.isnan(ani), 0.0, ani)
    return ani.clamp(0.0, 1.0) * 100.0


def dot_threshold_compact(
    r_hv: torch.Tensor, norm2_r: torch.Tensor, q_hv: torch.Tensor,
    norm2_q: torch.Tensor, threshold: float, ksize: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dot tile, ANI filter and compaction on the device.

    Keeps the pairs whose device ANI is at least threshold - 0.01 (the JAX
    package's margin for float drift against the host chain). Returns
    (flat index int64 [K] into the [M, N] tile, exact int32 dot [K]).
    """
    dot = dot_i16_exact(r_hv, q_hv)
    ani = ani_from_dot_matrix(dot, norm2_r, norm2_q, ksize)
    keep = ani >= torch.tensor(threshold, dtype=torch.float32) - 0.01
    idx = keep.reshape(-1).nonzero().squeeze(-1)
    return idx, dot.reshape(-1)[idx]
