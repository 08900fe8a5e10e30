"""HDC random-indexing HV encoder (reference:src/hd.rs:94-112).

Counterpart of ``hypergen_tpu.ops.encode``. Each hash seeds a wyrng whose
state is a counter, so all D/64 words of every hash are computed at once
(``ops.hashes.wyrng_words_from_hash``), and

    hv[i*64 + j] = sum over hashes h of (2*bit_j(word_i(h)) - 1).

This is the expand-and-sum form; the JAX package's carry-save-adder tree is
a TPU vector-unit trick that gives the same integers.
"""

from __future__ import annotations

import torch

from hypergen_tpu_torch.ops.hashes import (
    wyrng_word_offsets,
    wyrng_words_from_hash,
)
from hypergen_tpu_torch.ops.u64 import wrap_i32


def encode_hv(
    h: torch.Tensor, valid: torch.Tensor, hv_d: int, block: int = 256
) -> torch.Tensor:
    """Bundle hashes into an int32 HV: 2*sum(bits) - n_valid per row.

    h: int64 [B, N] hashes (u64 bits); valid: bool [B, N], False entries
    contribute nothing. Hashes go through in blocks of ``block`` to bound
    the [B, block, hv_d] bit tensor. Returns int32 [B, hv_d].
    """
    if hv_d % 64 != 0:
        raise ValueError("hv_d must be a multiple of 64")
    B, N = h.shape
    offsets = wyrng_word_offsets(hv_d // 64, device=h.device)
    shifts = torch.arange(64, device=h.device)
    acc = torch.zeros((B, hv_d), dtype=torch.int64, device=h.device)
    for lo in range(0, N, block):
        words = wyrng_words_from_hash(h[:, lo : lo + block], offsets)
        bits = (words[..., None] >> shifts) & 1  # [B, n, W, 64]
        n = words.shape[1]
        bits = bits.reshape(B, n, hv_d) * valid[:, lo : lo + n, None]
        acc += bits.sum(dim=1)
    n_valid = valid.sum(dim=-1, keepdim=True)
    return wrap_i32(2 * acc - n_valid)


def hv_to_i16(hv: torch.Tensor) -> torch.Tensor:
    """Wrap to int16 like the reference's i16 accumulation
    (overflow-checks=false; reference:src/hd.rs:97). The wrap is done in
    int64 arithmetic, so it does not rest on how a cast narrows."""
    x = hv.to(torch.int64)
    return (((x + 32768) & 0xFFFF) - 32768).to(torch.int16)


def hv_norm2_i32(hv_i16: torch.Tensor) -> torch.Tensor:
    """Wrapping-i32 sum of squares (reference:src/dist.rs:132-137). The sum
    is exact in int64 (|v| <= 2^15), then wrapped to int32."""
    x = hv_i16.to(torch.int64)
    return wrap_i32((x * x).sum(dim=-1))
