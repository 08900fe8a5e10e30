"""The yardstick's arithmetic: peaks of the card, and the operations and
bytes each kernel's work needs, from its inputs.

Frozen copies of ``chip_smoke.py``'s ``t1ha2_mads``, ``bound``,
``k1_bound`` and ``encode_bound`` (the recount of 4 NW + 10 multiply-adds a
t1ha2 hash and 4 a (valid hash, wyrng word)), taking counts instead of
tensors, and the search's bound. A bound is the least time the card could
take: the larger of the bytes over the HBM rate and the operations over the
unit's peak. Every input byte is counted read once and every output byte
written once. Peaks are NVIDIA's data sheet of the H100 SXM at its 700 W
limit (dense, no sparsity).
"""

from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12
# integer multiply-adds at 64 INT32 lanes an SM, half the 128 FP32 lanes
# behind the 67 TFLOP/s float32 rate (two flops an FMA)
INT32_MAD_PER_S = 67e12 / 4
# dense int8 tensor-core operations (a multiply-add is two)
INT8_OPS_PER_S = 1979e12

# 32-bit multiply-adds of one (valid hash, wyrng word) pair of the encode:
# one 64 x 64 -> 128-bit product, four 32 x 32 -> 64 partial products
ENCODE_MADS = 4


def t1ha2_mads(k: int) -> int:
    """32-bit multiply-adds of one t1ha2 hash of a k-mer: NW = ceil(k/8)
    mixups of one 128-bit product (four partial products) each, and the
    final mix's two low-only products (three each) and one 128-bit product
    (four): 4 NW + 10."""
    nw = (k + 7) // 8
    return 4 * nw + 10


def bound(n_bytes: float, n_mads: float) -> Tuple[float, str]:
    """(seconds, what bounds it) for int32 multiply-add work."""
    by_bytes = n_bytes / HBM_BYTES_PER_S
    by_ops = n_mads / INT32_MAD_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def k1_bound(rows: int, words: int, n_pos_sum: int, n_chunks: int, k: int,
             cap: int, cells: int) -> Tuple[float, str]:
    """K1 over ``rows`` rows of ``words`` u32 words each: the packed words
    and n_pos read once, the slots (h, pos, valid) and cell_max written
    once; a t1ha2 hash for every position below each row's n_pos (their
    sum, not the padded shape)."""
    slots = n_chunks * cap * cells
    n_bytes = rows * words * 4 + rows * 4 + rows * slots * (8 + 4 + 1) + rows * 4
    return bound(n_bytes, n_pos_sum * t1ha2_mads(k))


def encode_bound(rows: int, valid_hashes: int, hv_d: int) -> Tuple[float, str]:
    """The encode of ``rows`` HVs from ``valid_hashes`` distinct hashes in
    all: each valid hash (8 bytes) and its flag read once, the int16 HVs
    and their norms written once; ENCODE_MADS multiply-adds a (valid hash,
    word)."""
    n_bytes = valid_hashes * 9 + rows * (hv_d * 2 + 4)
    return bound(n_bytes, valid_hashes * (hv_d // 64) * ENCODE_MADS)


def search_bound(m: int, n: int, d: int, k_top: int) -> Tuple[float, str]:
    """A top-k search of n queries against m rows of d int16 values: m n d
    int16 multiply-adds, counted as 2 m n d operations at the int8
    tensor-core peak (no exact int16 product on the card beats one int8
    product), or the database, the queries, their norms and the top-k
    outputs (ANI float32, row int32, dot int32) moved once."""
    n_bytes = (m + n) * (d * 2 + 4) + n * k_top * 12
    by_bytes = n_bytes / HBM_BYTES_PER_S
    by_ops = 2.0 * m * n * d / INT8_OPS_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")
