"""BitPacker8x-compatible HV compression (numpy, fully vectorized).

The reference compresses sketch HVs with the `bitpacking` crate's
BitPacker8x (reference:src/hd.rs:139-157): blocks of 256 u32 values in the
SIMD-BP "vertical" AVX2 layout —

  - a block is viewed as 32 groups of 8 consecutive values (8 lanes);
  - within lane l, the 32 values v[8j+l] (j=0..31) are bit-packed LSB-first
    into a contiguous 32*b-bit stream = b u32 words;
  - output register i (i=0..b-1) holds word i of every lane, so word i of
    lane l lives at byte offset 32*i + 4*l.

Quantization (reference:src/hd.rs:120-141): find minimal b in [6,16] with
[-2^(b-1), 2^(b-1)-1] covering the HV, add offset 2^(b-1), pack low b bits.
The i16 wrapping quirks of the b=16 path are reproduced exactly (offset
arithmetic is congruent mod 2^16).

The reference's non-AVX2 scalar branches use a *different, inconsistent*
format with a sign bug (reference:src/hd.rs:158-166,213-229); per the survey
only the AVX2 format is implemented.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from hypergen_tpu_torch.params import QUANT_BITS_MAX, QUANT_BITS_MIN

BLOCK = 256
_SHIFT32 = np.arange(32, dtype=np.uint32)


def find_quant_bits(hv: np.ndarray) -> int:
    """Minimal lossless bit width in [6, 16] (reference:src/hd.rs:120-136)."""
    lo = int(hv.min()) if hv.size else 0
    hi = int(hv.max()) if hv.size else 0
    b = QUANT_BITS_MIN
    while b < QUANT_BITS_MAX:
        if -(1 << (b - 1)) <= lo and hi <= (1 << (b - 1)) - 1:
            break
        b += 1
    return b


def pack_hv(hv: np.ndarray, bits: int) -> np.ndarray:
    """int16 HV [D] (D % 256 == 0) -> packed bytes [D*bits/8]."""
    D = hv.shape[0]
    if D % BLOCK != 0:
        raise ValueError(f"hv_d must be a multiple of {BLOCK} for compression")
    offset = 1 << (bits - 1)
    vals = ((hv.astype(np.int32) + offset) & ((1 << bits) - 1)).astype(np.uint32)
    nblk = D // BLOCK
    lanes = vals.reshape(nblk, 32, 8).transpose(0, 2, 1)  # [nblk, lane, j]
    tbits = np.arange(bits, dtype=np.uint32)
    bit_mat = (lanes[..., None] >> tbits) & np.uint32(1)  # [nblk, 8, 32, bits]
    stream = bit_mat.reshape(nblk, 8, 32 * bits)  # bit index = j*bits + t
    words_bits = stream.reshape(nblk, 8, bits, 32)  # [.., word, bit-in-word]
    words = np.sum(
        words_bits.astype(np.uint64) << _SHIFT32.astype(np.uint64), axis=-1
    ).astype(np.uint32)  # [nblk, 8, bits]
    out = words.transpose(0, 2, 1)  # [nblk, bits(register), lane]
    return np.ascontiguousarray(out).astype("<u4").tobytes()


def unpack_hv(packed: bytes, bits: int, hv_d: int) -> np.ndarray:
    """Packed bytes -> int16 HV [hv_d] (reference:src/hd.rs:190-212)."""
    expect = bits * hv_d // 8
    if len(packed) != expect:
        # an oversized buffer means the stored quant_bits disagrees with
        # the byte count — decoding a prefix at the wrong width would
        # return silent garbage HVs
        raise ValueError(
            f"packed buffer length {len(packed)} != expected {expect} "
            f"for bits={bits}, hv_d={hv_d}"
        )
    nblk = hv_d // BLOCK
    words = (
        np.frombuffer(packed[:expect], dtype="<u4")
        .reshape(nblk, bits, 8)
        .transpose(0, 2, 1)  # [nblk, lane, word]
    )
    bit_mat = (words[..., None] >> _SHIFT32) & np.uint32(1)  # [nblk, 8, bits, 32]
    stream = bit_mat.reshape(nblk, 8, bits * 32)
    vals_bits = stream.reshape(nblk, 8, 32, bits)
    tbits = np.arange(bits, dtype=np.uint32)
    vals = np.sum(vals_bits.astype(np.uint64) << tbits.astype(np.uint64), axis=-1)
    vals = vals.astype(np.uint32).transpose(0, 2, 1).reshape(hv_d)  # [D]
    offset = 1 << (bits - 1)
    r = (vals.astype(np.int64) - offset) & 0xFFFF
    return r.astype(np.uint16).view(np.int16).copy()


def compress_hv(hv: np.ndarray) -> Tuple[bytes, int]:
    """Full reference-compatible compression: returns (packed, quant_bits)."""
    bits = find_quant_bits(hv)
    return pack_hv(hv, bits), bits
