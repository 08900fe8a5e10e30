"""Canonical k-mer extraction and hashing over whole code arrays.

Counterpart of ``hypergen_tpu.ops.kmers``, and the plain PyTorch version
behind the CUDA hash kernel. The host supplies 2-bit base codes (0..3,
4 = invalid); for each of the P = L-k+1 window positions this builds,
from k shifted slices:

  - a validity flag (all k bases ACGT);
  - the fwd and rc 2-bit keys (first base most significant), and the
    canonical strand by unsigned key compare, which equals the reference's
    bytewise strcmp because A<C<G<T holds in both ASCII and code order;
  - the canonical k-mer's ASCII bytes as little-endian u64 words, the
    exact t1ha2_atonce input;

then hashes every window (t1ha2, or mm_hash64 of the key for "mmhash")
and applies the FracMinHash threshold.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from hypergen_tpu_torch.ops.hashes import mm_hash64, t1ha2_atonce_words
from hypergen_tpu_torch.ops.u64 import lt, lt_const

INVALID_CODE = 4  # the host codes non-ACGT bases as 4
_ASCII = (65, 67, 71, 84)  # code 0..3 -> A C G T


def canonical_kmer_words(
    codes: torch.Tensor, ksize: int, canonical: bool = True
) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Per-position t1ha2 input words, canonical 2-bit key and validity.

    codes: integer tensor [..., L] of base codes, L >= ksize. Returns
    (words, key, valid): ceil(k/8) int64 [..., P] words of little-endian
    ASCII bytes with the tail zero-padded, the canonical key int64
    [..., P], and valid bool [..., P].

    The per-base arrays (2-bit code, complement, ASCII) are built once over
    L and each window reads them as shifted slices, with the keys and words
    built in place: the arrays are [batch, chunks, C] large, so each pass
    avoided is a pass over memory.
    """
    if not 1 <= ksize <= 32:
        raise ValueError("ksize must be in [1, 32]")
    codes = codes.to(torch.int64)
    P = codes.shape[-1] - ksize + 1
    if P < 1:
        raise ValueError(f"chunk too short: L={codes.shape[-1]} < k={ksize}")
    c = codes & 3
    comp = 3 - c
    # a window is valid when no code in it is invalid: a prefix count of
    # invalid codes, differenced over k
    inv = torch.cumsum(torch.nn.functional.pad(
        (codes >= INVALID_CODE).to(torch.int32), (1, 0)), -1,
        dtype=torch.int32)
    valid = inv[..., ksize:] == inv[..., :P]
    fwd = torch.zeros(valid.shape, dtype=torch.int64, device=codes.device)
    rc = torch.zeros_like(fwd)
    for j in range(ksize):
        fwd <<= 2
        fwd |= c[..., j : j + P]
        rc <<= 2
        rc |= comp[..., ksize - 1 - j : ksize - 1 - j + P]
    if canonical:
        is_rc = lt(rc, fwd)
        key = torch.where(is_rc, rc, fwd)
    else:
        key = fwd

    ascii_ = torch.tensor(_ASCII, dtype=torch.int64, device=codes.device)
    fwd_ascii = ascii_[c]
    rc_ascii = ascii_[comp] if canonical else None
    words = [torch.zeros_like(fwd) for _ in range((ksize + 7) // 8)]
    for j in range(ksize):
        b = fwd_ascii[..., j : j + P]
        if canonical:
            r = ksize - 1 - j
            b = torch.where(is_rc, rc_ascii[..., r : r + P], b)
        words[j // 8] |= b << (8 * (j % 8))
    return words, key, valid


def hash_kmer_positions(
    codes: torch.Tensor,
    ksize: int,
    seed: int,
    threshold: int,
    canonical: bool = True,
    method: str = "t1ha2",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hash every k-mer window and apply the FracMinHash filter.

    Returns (hash int64 [..., P], keep bool [..., P]) with keep =
    window-valid and hash < threshold (reference:src/sketch.rs:90-94);
    hashes that are not kept are zeroed.
    """
    words, key, valid = canonical_kmer_words(codes, ksize, canonical)
    if method == "t1ha2":
        h = t1ha2_atonce_words(words, ksize, seed)
    elif method == "mmhash":
        h = mm_hash64(key)
    else:
        raise ValueError(f"unknown sketch method {method!r}")
    keep = valid & lt_const(h, threshold)
    return torch.where(keep, h, 0), keep
