"""64-bit hash primitives on int64 tensors (u64 bit patterns).

- t1ha2_atonce over byte windows of up to 32 bytes (the k-mer hash,
  reference:src/sketch.rs:90);
- mm_hash64, the Thomas Wang mix (reference:src/types.rs:22-32), for the
  "mmhash" sketch method;
- wyrng output words in closed form for the HV encoder: the state is a
  counter, so word_i(h) = wymum((h+(i+1)P0)^P1, h+(i+1)P0).

Counterpart of ``hypergen_tpu.ops.hashes``; every function is elementwise
over the leading dims, and lengths, seeds and word counts are Python ints.
"""

from __future__ import annotations

from typing import Sequence

import torch

from hypergen_tpu_torch.params import (
    T1HA_PRIME_0,
    T1HA_PRIME_1,
    T1HA_PRIME_2,
    T1HA_PRIME_3,
    T1HA_PRIME_4,
    T1HA_PRIME_5,
    T1HA_PRIME_6,
    WY_P0,
    WY_P1,
)
from hypergen_tpu_torch.ops.u64 import i64, mulhi, rotr, shr


def _mixup64(a, b, v, prime: int):
    """a ^= lo128((b + v) * prime); b += hi128. Returns (a, b)."""
    t = b + v
    return a ^ (t * i64(prime)), b + mulhi(t, prime)


def _mux64(v, prime: int):
    """lo ^ hi of v*prime (reference:src/cuda_kernel.cu:143-147)."""
    return (v * i64(prime)) ^ mulhi(v, prime)


def _final64(a, b):
    x = (a + rotr(b, 41)) * i64(T1HA_PRIME_0)
    y = (rotr(a, 23) + b) * i64(T1HA_PRIME_6)
    return _mux64(x ^ y, T1HA_PRIME_5)


def t1ha2_atonce_words(
    words: Sequence[torch.Tensor], length: int, seed: int,
    shape=(), device=None,
) -> torch.Tensor:
    """t1ha2_atonce over little-endian u64 data words, for length <= 32.

    ``words`` holds ceil(length/8) int64 tensors; the last must already be
    masked to the trailing ``length % 8`` bytes, as tail64_le_unaligned
    gives it (reference:src/cuda_kernel.cu:155-194). ``shape`` and
    ``device`` matter only for length 0, which has no words.
    """
    if not 0 <= length <= 32:
        raise ValueError("t1ha2_atonce_words supports length in [0, 32]")
    n_words = (length + 7) // 8
    if len(words) != n_words:
        raise ValueError(f"expected {n_words} words for length {length}")
    if words:
        shape, device = words[0].shape, words[0].device
    a = torch.full(shape, i64(seed), dtype=torch.int64, device=device)
    b = torch.full(shape, length, dtype=torch.int64, device=device)
    idx = 0
    if length > 24:
        a, b = _mixup64(a, b, words[idx], T1HA_PRIME_4)
        idx += 1
    if length > 16:
        b, a = _mixup64(b, a, words[idx], T1HA_PRIME_3)
        idx += 1
    if length > 8:
        a, b = _mixup64(a, b, words[idx], T1HA_PRIME_2)
        idx += 1
    if length > 0:
        b, a = _mixup64(b, a, words[idx], T1HA_PRIME_1)
    return _final64(a, b)


def mm_hash64(key: torch.Tensor) -> torch.Tensor:
    """Thomas Wang 64-bit mix hash, wrapping (reference:src/types.rs:22-32)."""
    key = ~key + (key << 21)
    key = key ^ shr(key, 24)
    key = key + (key << 3) + (key << 8)
    key = key ^ shr(key, 14)
    key = key + (key << 2) + (key << 4)
    key = key ^ shr(key, 28)
    return key + (key << 31)


def wyrng_word_offsets(n_words: int, device=None) -> torch.Tensor:
    """(i+1)*P0 mod 2^64 for i in [0, n_words) as int64 [n_words]. Made on
    the device (int64 products wrap mod 2^64, as in wyrng_words_from_hash):
    a copy from the host would make the sketch step wait for the card."""
    i = torch.arange(1, n_words + 1, dtype=torch.int64, device=device)
    return i * i64(WY_P0)


def wyrng_words_from_hash(h: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """All wyrng output words of each hash: int64 [..., W].

    h: int64 [...]; offsets: int64 [W] from wyrng_word_offsets.
    word_i = wymum(s ^ P1, s) with s = h + (i+1)*P0.
    """
    s = h[..., None] + offsets
    x = s ^ i64(WY_P1)
    return (x * s) ^ mulhi(x, s)
