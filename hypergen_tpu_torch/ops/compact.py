"""Mask compaction of variable-count survivors, with true counts.

Counterpart of ``hypergen_tpu.ops.compact``. The TPU version extracts
survivors by masked max-reduces into fixed slot blocks (``block_extract``),
because a TPU has no cheap scatter, and retries when a block overflows. A
GPU scatters cheaply, so both compactions here scatter each kept entry to
its rank in the row. ``compact_masked`` sizes its output to the largest
true count, which it reads on the host; ``compact_to_width`` writes a width
fixed on the host, reads nothing back, and leaves overflow to the caller's
check of the true counts (the sketch step's collect-time retry).
"""

from __future__ import annotations

from typing import List, Tuple

import torch


def compact_masked(
    keep: torch.Tensor, *values: torch.Tensor
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Gather the kept entries of each row to the front of the row.

    keep: bool [B, P]; values: tensors [B, P]. Returns ([out [B, N] per
    value], count int64 [B]) with N = max(count) (at least 1): out[b,
    :count[b]] holds row b's kept entries in position order, and the rest
    of each row holds -1. Reads the largest count on the host.
    """
    counts = keep.sum(dim=-1)
    width = max(int(counts.max()), 1) if keep.shape[0] else 1
    rank = torch.cumsum(keep, dim=-1) - 1
    rows, cols = keep.nonzero(as_tuple=True)
    slot = rank[rows, cols]
    outs = []
    for v in values:
        out = torch.full((keep.shape[0], width), -1, dtype=v.dtype,
                         device=v.device)
        out[rows, slot] = v[rows, cols]
        outs.append(out)
    return outs, counts


def compact_to_width(
    keep: torch.Tensor, width: int, *values: torch.Tensor
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """compact_masked into a fixed width, with no read of the device.

    keep: bool [B, P]; values: tensors [B, P]; width >= 1. Returns ([out
    [B, width] per value], count int64 [B]): out[b, :min(count[b], width)]
    holds row b's first kept entries in position order, the rest of each
    row holds -1, and count[b] is the row's true count. A row whose count
    exceeds width has lost entries: the caller checks count and reruns
    with a larger width. Each entry's rank is a cumulative sum; dropped
    and overflowing entries scatter to one spill column past the width.
    """
    B = keep.shape[0]
    slot = torch.cumsum(keep, dim=-1)  # int64: the 1-based rank
    counts = slot[:, -1].clone()
    slot.sub_(1)
    slot.masked_fill_(~keep | (slot >= width), width)
    outs = []
    for v in values:
        out = torch.full((B, width + 1), -1, dtype=v.dtype, device=v.device)
        out.scatter_(1, slot, v)
        outs.append(out[:, :width])
    return outs, counts
