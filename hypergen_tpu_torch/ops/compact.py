"""Mask compaction of variable-count survivors, with true counts.

Counterpart of ``hypergen_tpu.ops.compact``. The TPU version extracts
survivors by masked max-reduces into fixed slot blocks (``block_extract``),
because a TPU has no cheap scatter, and retries when a block overflows. A
GPU scatters cheaply and PyTorch has dynamic shapes, so this compaction
sizes its output to the largest true count and never overflows.
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
