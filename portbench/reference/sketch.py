"""Plain reference of HyperGen's sketch, in PyTorch, from base codes.

A frozen statement of what a sketch is (the HyperGen tool's CPU path,
wh-xu/Hyper-Gen src/sketch.rs and src/hd.rs), written out here and
importing nothing of the program:

- every window of k bases that holds no invalid code (N, another letter,
  or the separator between two contigs) is a k-mer; its canonical form is
  the smaller of the k-mer and its reverse complement as ASCII strings;
- its hash is t1ha2_atonce of those k ASCII bytes with the sketch's seed;
- FracMinHash keeps the hashes below U64_MAX // scaled, and the set of
  distinct kept hashes is the genome's sketch;
- each kept hash seeds a wyrng (state h; each draw adds P0 and returns
  wymum(s ^ P1, s)), whose D/64 words give D bits; the HV counts +1 for a
  set bit and -1 for a clear one over all hashes, in i16 arithmetic that
  wraps;
- the norm is the wrapping i32 sum of the HV's squares.

u64 values are held as int64 with the same bits. Work runs in blocks of
positions on the given device.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

INVALID = 4
U64 = (1 << 64) - 1
M32 = 0xFFFFFFFF
T1HA_P = (0xEC99BF0D8372CAAB, 0x82434FE90EDCEF39, 0xD4F06DB99D67BE4B,
          0xBD9CACC22C6E9571, 0x9C06FAF4D023E3AB, 0xC060724A8424F345,
          0xCB5AF53AE3AAAC31)
WY_P0, WY_P1 = 0xA0761D6478BD642F, 0xE7037ED1A0B428DB


def s64(v: int) -> int:
    """A u64 constant as the int64 of the same bits."""
    v &= U64
    return v - (1 << 64) if v >> 63 else v


def lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of u64 bits."""
    return (x >> s) & ((1 << (64 - s)) - 1) if s else x


def rot(x: torch.Tensor, s: int) -> torch.Tensor:
    return lsr(x, s) | (x << (64 - s))


def umulhi(a: torch.Tensor, b) -> torch.Tensor:
    """High 64 bits of the 128-bit product of two u64 values, by 32-bit
    halves."""
    a_lo, a_hi = a & M32, lsr(a, 32)
    if isinstance(b, int):
        b &= U64
        b_lo, b_hi = b & M32, b >> 32
    else:
        b_lo, b_hi = b & M32, lsr(b, 32)
    ll, lh, hl, hh = a_lo * b_lo, a_lo * b_hi, a_hi * b_lo, a_hi * b_hi
    carry = lsr(lsr(ll, 32) + (lh & M32) + (hl & M32), 32)
    return hh + lsr(lh, 32) + lsr(hl, 32) + carry


def ult(a: torch.Tensor, b: int) -> torch.Tensor:
    """Unsigned a < b for a constant b."""
    flip = -(1 << 63)
    return (a ^ flip) < s64(b ^ (1 << 63))


def t1ha2(words: List[torch.Tensor], length: int, seed: int) -> torch.Tensor:
    """t1ha2_atonce of ``length`` (17-32) bytes given as little-endian u64
    words, the last one holding only the tail's bytes."""
    a = torch.full_like(words[0], s64(seed))
    b = torch.full_like(words[0], length)

    def mixup(x, y, v, prime):  # x ^= lo(y + v) * p; y += hi
        t = y + v
        return x ^ (t * s64(prime)), y + umulhi(t, prime)

    i = 0
    if length > 24:
        a, b = mixup(a, b, words[i], T1HA_P[4])
        i += 1
    b, a = mixup(b, a, words[i], T1HA_P[3])
    a, b = mixup(a, b, words[i + 1], T1HA_P[2])
    b, a = mixup(b, a, words[i + 2], T1HA_P[1])
    x = (a + rot(b, 41)) * s64(T1HA_P[0])
    y = (rot(a, 23) + b) * s64(T1HA_P[6])
    v = x ^ y
    return (v * s64(T1HA_P[5])) ^ umulhi(v, T1HA_P[5])


def kept_hashes(codes: torch.Tensor, k: int, seed: int, threshold: int,
                canonical: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(window starts, hashes) of the kept k-mers of a code array."""
    if not 17 <= k <= 32:
        raise ValueError("this reference hashes k in [17, 32]")
    c = codes.to(torch.int64)
    P = c.numel() - k + 1
    bad = torch.cumsum(torch.nn.functional.pad((c >= INVALID).to(torch.int32),
                                               (1, 0)), 0)
    valid = bad[k:] == bad[:P]
    b = c & 3
    fwd = torch.zeros(P, dtype=torch.int64, device=c.device)
    rc = torch.zeros_like(fwd)
    for j in range(k):
        fwd = (fwd << 2) | b[j : j + P]
        rc = rc | ((3 - b[j : j + P]) << (2 * j))
    key = torch.where((rc ^ -(1 << 63)) < (fwd ^ -(1 << 63)), rc, fwd) \
        if canonical else fwd
    ascii_ = torch.tensor([65, 67, 71, 84], dtype=torch.int64, device=c.device)
    words = [torch.zeros_like(fwd) for _ in range((k + 7) // 8)]
    for j in range(k):
        base = lsr(key, 2 * (k - 1 - j)) & 3
        words[j // 8] = words[j // 8] | (ascii_[base] << (8 * (j % 8)))
    h = t1ha2(words, k, seed)
    keep = valid & ult(h, threshold)
    pos = keep.nonzero().squeeze(1)
    return pos, h[pos]


def wyrng_bits(h: torch.Tensor, hv_d: int) -> torch.Tensor:
    """The D bits of each hash's wyrng draws: uint8 [n, D], bit j of draw i
    at i * 64 + j."""
    i = torch.arange(1, hv_d // 64 + 1, dtype=torch.int64, device=h.device)
    s = h[:, None] + i * s64(WY_P0)
    x = s ^ s64(WY_P1)
    w = (x * s) ^ umulhi(x, s)
    j = torch.arange(64, dtype=torch.int64, device=h.device)
    return ((w[..., None] >> j) & 1).to(torch.uint8).reshape(h.numel(), hv_d)


def wrap(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Two's-complement wrap of integers to ``bits`` bits, as int64."""
    half = 1 << (bits - 1)
    return ((x + half) & ((1 << bits) - 1)) - half


def sketch_genomes(genomes: List[np.ndarray], sketch: dict, device,
                   hv_bits: int = 16, block: int = 1 << 24):
    """Sketch genomes given as code arrays (0-3, INVALID). Returns (hv
    int16 [n, D], norm2 int32 [n], n_hashes int64 [n]) as numpy arrays.
    hv_bits is the width the bundle wraps in: 16 as HyperGen states it;
    the control's lower precision takes 8."""
    k, D = sketch["ksize"], sketch["hv_d"]
    threshold = U64 // sketch["scaled"]
    sep = np.array([INVALID], np.uint8)
    flat = np.concatenate([x for g in genomes for x in (g, sep)])
    starts = np.cumsum([0] + [g.size + 1 for g in genomes])
    owner, hashes = [], []
    for lo in range(0, max(flat.size - k + 1, 0), block):
        hi = min(lo + block + k - 1, flat.size)
        codes = torch.from_numpy(flat[lo:hi]).to(device)
        pos, h = kept_hashes(codes, k, sketch["seed"], threshold,
                             sketch["canonical"])
        g = torch.searchsorted(torch.from_numpy(starts).to(device), pos + lo,
                               right=True) - 1
        owner.append(g)
        hashes.append(h)
    owner = torch.cat(owner)
    hashes = torch.cat(hashes)
    # distinct (genome, hash) pairs: sort by hash, then stably by genome
    order = torch.argsort(hashes, stable=True)
    owner, hashes = owner[order], hashes[order]
    order = torch.argsort(owner, stable=True)
    owner, hashes = owner[order], hashes[order]
    first = torch.ones_like(owner, dtype=torch.bool)
    first[1:] = (owner[1:] != owner[:-1]) | (hashes[1:] != hashes[:-1])
    owner, hashes = owner[first], hashes[first]
    n = len(genomes)
    counts = torch.zeros((n, D), dtype=torch.int32, device=device)
    step = max(1, (1 << 24) // D)
    for lo in range(0, hashes.numel(), step):
        bits = wyrng_bits(hashes[lo : lo + step], D).to(torch.int32)
        counts.index_add_(0, owner[lo : lo + step], bits)
    n_h = torch.bincount(owner, minlength=n).to(torch.int64)
    hv = wrap(2 * counts.to(torch.int64) - n_h[:, None], hv_bits)
    norm2 = wrap((hv * hv).sum(-1), 32)
    return (hv.to(torch.int16).cpu().numpy(), norm2.to(torch.int32).cpu().numpy(),
            n_h.cpu().numpy())
