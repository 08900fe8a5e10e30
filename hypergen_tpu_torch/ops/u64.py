"""Unsigned 64-bit arithmetic on torch int64 tensors.

torch has no uint64 add, shift or ``<``, so a u64 is held as the int64
with the same bits. Add, subtract, multiply, xor, and, or and left shift
already wrap mod 2^64 on those bits. What differs from signed int64 lives
here: the logical right shift (arithmetic ``>>``, then a mask), the
unsigned compare (flip bit 63, then signed ``<``) and the high half of a
64x64 product, built from 32-bit limbs.
"""

from __future__ import annotations

import numpy as np
import torch

U64_MASK = (1 << 64) - 1
M32 = 0xFFFFFFFF
_SIGN = -(1 << 63)


def i64(value: int) -> int:
    """A Python-int u64 constant as the int64 with the same bits."""
    value &= U64_MASK
    return value - (1 << 64) if value >> 63 else value


def from_numpy(arr: np.ndarray) -> torch.Tensor:
    """Host uint64 array -> int64 tensor with the same bits."""
    return torch.from_numpy(
        np.ascontiguousarray(arr, dtype=np.uint64).view(np.int64)
    )


def to_numpy(x: torch.Tensor) -> np.ndarray:
    """int64 tensor -> host uint64 array with the same bits."""
    return x.detach().cpu().numpy().view(np.uint64)


def shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift by a static amount in [0, 64)."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def rotr(x: torch.Tensor, s: int) -> torch.Tensor:
    """rot64(v, s) = (v >> s) | (v << (64 - s)) for s in (0, 64)."""
    return shr(x, s) | (x << (64 - s))


def lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a < b."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def lt_const(a: torch.Tensor, value: int) -> torch.Tensor:
    """Unsigned a < value for a Python-int u64 constant."""
    return (a ^ _SIGN) < i64((value & U64_MASK) ^ (1 << 63))


def mulhi(a: torch.Tensor, b) -> torch.Tensor:
    """High 64 bits of the unsigned 128-bit product a*b.

    b is a tensor or a Python-int u64 constant. Each 32x32 limb product
    fits in u64, and the middle column sums three values below 2^32, so
    only the final sum wraps, and it wraps to the right answer.
    """
    a0, a1 = a & M32, shr(a, 32)
    if isinstance(b, int):
        b &= U64_MASK
        b0, b1 = b & M32, b >> 32
    else:
        b0, b1 = b & M32, shr(b, 32)
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = shr(p00, 32) + (p01 & M32) + (p10 & M32)
    return p11 + shr(p01, 32) + shr(p10, 32) + shr(mid, 32)


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """Integer tensor -> int32, wrapping mod 2^32 like a wrapping i32."""
    x = x.to(torch.int64) & M32
    return torch.where(x >> 31 != 0, x - (1 << 32), x).to(torch.int32)
