"""The bound of an all-pairs `dist` of one collection against itself, in
the yardstick of ``counts.py`` (its peaks; every input byte read once and
every output byte written once)."""

from __future__ import annotations

from typing import Tuple

from portbench.harness.counts import HBM_BYTES_PER_S, INT8_OPS_PER_S


def dist_bound(m: int, d: int, kept: int) -> Tuple[float, str]:
    """(seconds, what bounds it) for the pairs i < j of m rows of d int16
    values: m (m - 1) / 2 d int16 multiply-adds, counted as 2 operations
    each at the int8 tensor-core peak (no exact int16 product on the card
    beats one int8 product), or the rows and their norms read once and
    each kept pair (row int32, column int32, dot int32) written once."""
    pairs = m * (m - 1) // 2
    by_bytes = (m * (d * 2 + 4) + kept * 12) / HBM_BYTES_PER_S
    by_ops = 2.0 * pairs * d / INT8_OPS_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")
