"""ANI estimation from exact int16 HV dot products.

Counterpart of ``hypergen_tpu.ops.ani``. The reference accumulates
i16*i16 products into a wrapping i32 (reference:src/dist.rs:146-151). The
dot here is exact mod 2^32 in three modes, named as the JAX package's
``use_mxu`` values:

- ``True``, the 4-way int8 split, for any int16 values:

      v = 256*hi + (lo - 128) + 128,  hi = v >> 8,  lo = (v & 0xFF) - 128
      dot(r, q) = 65536*HH + 256*(HL + LH) + LL
                + 32768*(sum(RH) + sum(QH)) + 128*(sum(RL) + sum(QL)) + 16384*D

- ``"small"``, the 3-product Karatsuba split, valid only when every |value|
  is at most SMALL_SPLIT_MAX: v = 64*h + l with h, l and h + l in int8, and
  dot = 4096*HH + 64*(MM - HH - LL) + LL, where MM is the product of the
  h + l planes.

- ``False``, the direct dot: a float64 matrix product (|v| <= 2^15 and
  D < 2^23 keep every partial sum an exact integer below 2^53 in any
  order), wrapped to int32. It is the CPU's mode and the plain reference.

Each int8 product is ``torch._int_mm`` (int8 x int8 -> int32: the tensor
cores on a CUDA card, PyTorch's own kernel on the CPU). The combines are
int32 tensor arithmetic, which wraps mod 2^32 on both, as the JAX package's
int32 arithmetic does, so every mode gives the same int32 bits.

``mode=None`` resolves as the JAX package's ``_resolve_mxu``: on a CUDA
device ``"small"`` when every value of both operands fits, else ``True``;
on the CPU ``False``. The bound is read from the operands where they lie:
a tensor on the card is reduced there (``bound_on_device``, one fused
min/max pass) and read with one host read. Every product counts its mode
in ``utils.timing.COUNTERS``: ``dot_tiles_small`` (3 products) and
``dot_tiles_split4`` (4); the direct dot counts nothing.

The device float32 ANI map only ranks and filters pairs (with a margin);
every printed value comes from the host float32 chain in
``models.comparator``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from hypergen_tpu_torch.ops.u64 import wrap_i32
from hypergen_tpu_torch.utils.timing import count

# |values| up to this bound admit the 3-product split: l = ((v+32) & 63) - 32
# in [-32, 31] and h = (v+32) >> 6 in [-96, 96], so h, l and h + l all fit
# int8 (at 6176, h + l would need 128)
SMALL_SPLIT_MAX = 6175


class SmallSplit(NamedTuple):
    """A resident operand split for the 3-product mode: int8 planes h, l
    and their sum. Only valid when the operand's values fit
    SMALL_SPLIT_MAX (see presplit_rows_small)."""

    h: torch.Tensor
    l: torch.Tensor
    hl: torch.Tensor


def bound_on_device(t: torch.Tensor) -> torch.Tensor:
    """max |value| of the int tensor t as an int32 0-d tensor on t's
    device: one fused min/max pass (``torch.aminmax``) and no host read;
    int32 sidesteps the int16 -32768 negation wrap. 0 for an empty t."""
    if not t.numel():
        return t.new_zeros((), dtype=torch.int32)
    lo, hi = torch.aminmax(t)
    return torch.maximum(hi.to(torch.int32), -lo.to(torch.int32))


def abs_bound(t: torch.Tensor) -> int:
    """max |value| of an int tensor, reduced on its device and read with
    one host read (bound_on_device)."""
    return int(bound_on_device(t))


def resolve_mode(mode, device, *hv_arrays):
    """None -> True on a CUDA device, False on the CPU; True -> "small"
    when every value of every operand fits SMALL_SPLIT_MAX (abs_bound: a
    tensor is reduced where it lies). Any other mode is returned as it
    is, with no scan."""
    if mode is None:
        mode = torch.device(device).type == "cuda"
    if mode is True and all(
        abs_bound(a) <= SMALL_SPLIT_MAX for a in hv_arrays
    ):
        return "small"
    return mode


def split_i16_to_i8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x == 256*hi + (lo + 128); hi, lo both exactly representable in int8.

    hi = x >> 8 is x's high byte and lo = (x & 0xFF) - 128 its low byte
    with the top bit flipped, so both come from the little-endian bytes of
    x in one pass each."""
    b = x.to(torch.int16).contiguous().view(torch.int8)
    return b[..., 1::2].contiguous(), b[..., 0::2] ^ -128


def _split_small(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """h = (x + 32) >> 6, l = ((x + 32) & 63) - 32, both cast to int8. In
    int16 arithmetic: the low bits the int8 casts keep are those of the
    JAX package's int32 arithmetic for every int16 x."""
    x16 = x.to(torch.int16) + 32
    return (x16 >> 6).to(torch.int8), (x16 & 63).to(torch.int8) - 32


def _pad2(a: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if a.shape == (rows, cols):
        return a
    out = a.new_zeros((rows, cols))
    out[: a.shape[0], : a.shape[1]] = a
    return out


def _mm_i8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int32 [m, n] product of int8 a [m, D] and b [n, D] (b's rows are the
    columns of the result), one ``torch._int_mm``.

    On the card, cuBLASLt's int8 product needs m > 16 and D and n multiples
    of 8: the planes get zero rows and columns, which add nothing to a dot,
    and the result is cut back."""
    m, n = a.shape[0], b.shape[0]
    if not a.is_cuda:
        return torch._int_mm(a, b.T)
    d = -(-a.shape[1] // 8) * 8
    mp, np_ = max(m, 17), -(-n // 8) * 8
    out = torch._int_mm(_pad2(a, mp, d), _pad2(b, np_, d).T)
    return out if (mp, np_) == (m, n) else out[:m, :n].contiguous()


def presplit_rows(r: torch.Tensor):
    """A resident operand's 4-way planes and row correction, computed once:
    (hi int8 [M, D], lo int8 [M, D], row int32 [M]) for dot_i16_presplit.
    The same bytes as the int16 original."""
    rh, rl = split_i16_to_i8(r)
    row = (rh.sum(-1, dtype=torch.int32) << 15) + (
        rl.sum(-1, dtype=torch.int32) << 7
    )
    return rh, rl, row


def presplit_rows_small(r: torch.Tensor) -> SmallSplit:
    """A resident operand's 3-product planes (h, l, h + l). The caller has
    checked abs_bound(r) <= SMALL_SPLIT_MAX."""
    h, l = _split_small(r)
    return SmallSplit(h, l, h + l)


def dot_i16_presplit_small(r: SmallSplit, q: torch.Tensor) -> torch.Tensor:
    """3-product exact dot with r split by presplit_rows_small; q must also
    fit SMALL_SPLIT_MAX. 4096*HH + 64*(MM - HH - LL) + LL is combined as
    64*MM + 4032*HH - 63*LL, in place on int32, wrapping."""
    qh, ql = _split_small(q)
    out = _mm_i8(r.l, ql)
    out *= -63
    out.add_(_mm_i8(r.h, qh), alpha=4032)
    out.add_(_mm_i8(r.hl, qh + ql), alpha=64)
    return out


def dot_i16_presplit(
    rh: torch.Tensor, rl: torch.Tensor, row: torch.Tensor, q: torch.Tensor
) -> torch.Tensor:
    """4-way exact dot with r split by presplit_rows. The combine runs in
    place on int32, wrapping, one pass a product and one a correction."""
    D = q.shape[-1]
    qh, ql = split_i16_to_i8(q)
    out = _mm_i8(rl, ql)
    out.add_(_mm_i8(rh, qh), alpha=1 << 16)
    out.add_(_mm_i8(rh, ql), alpha=1 << 8)
    out.add_(_mm_i8(rl, qh), alpha=1 << 8)
    const = ((16384 * D + (1 << 31)) % (1 << 32)) - (1 << 31)
    col = (qh.sum(-1, dtype=torch.int32) << 15) + (
        ql.sum(-1, dtype=torch.int32) << 7
    )
    out += row[:, None]
    out += (col + const)[None, :]
    return out


def dot_i16_exact(r: torch.Tensor, q: torch.Tensor, mode=None) -> torch.Tensor:
    """Int32 [M, N] dot matrix of int16 HVs r [M, D], q [N, D], bit-exact
    (mod 2^32) against a wrapping i32 accumulation, in any mode (module
    docstring; None resolves by r's device and the values)."""
    mode = resolve_mode(mode, r.device, r, q) if mode is None else mode
    if mode == "small":
        count("dot_tiles_small")
        return dot_i16_presplit_small(presplit_rows_small(r), q)
    if mode:
        count("dot_tiles_split4")
        return dot_i16_presplit(*presplit_rows(r), q)
    d = torch.matmul(r.to(torch.float64), q.to(torch.float64).T)
    return wrap_i32(d.to(torch.int64))


def dot_i16_any(r, q: torch.Tensor, mode=True) -> torch.Tensor:
    """dot_i16_exact that also takes a presplit r: a SmallSplit or a
    (hi, lo, row) tuple.

    A SmallSplit r with a mode other than "small" (an over-bound query batch
    against a small-resident DB) rebuilds the exact int16 rows (x = 64*h + l)
    and takes the requested mode, so the result never depends on the
    resident layout."""
    if isinstance(r, SmallSplit):
        if mode == "small":
            count("dot_tiles_small")
            return dot_i16_presplit_small(r, q)
        x = (64 * r.h.to(torch.int32) + r.l.to(torch.int32)).to(torch.int16)
        return dot_i16_exact(x, q, mode)
    if isinstance(r, tuple):
        count("dot_tiles_split4")
        return dot_i16_presplit(*r, q)
    return dot_i16_exact(r, q, mode)


def ani_from_dot_matrix(
    dot: torch.Tensor, norm2_r: torch.Tensor, norm2_q: torch.Tensor,
    ksize: int,
) -> torch.Tensor:
    """float32 ANI%% matrix (reference:src/dist.rs:150-161).

    dot: int32 [M, N]; norm2_r: int32 [M]; norm2_q: int32 [N]. The
    denominator wraps in int32 as the reference's does. NaN -> 0, clamp to
    [0, 1], times 100. In place after the first two temporaries, so a
    65,536 x 4,096 search tile holds about three times the dot's bytes. May
    differ from the host chain (and from XLA's) in the last float bits,
    which the threshold margin of dot_threshold_compact covers.
    """
    den = norm2_r.to(torch.int32)[:, None] + norm2_q.to(torch.int32)[None, :]
    den -= dot
    ani = dot.to(torch.float32)
    ani /= den
    del den
    ani.reciprocal_().add_(1.0)
    torch.div(ani.new_tensor(2.0), ani, out=ani)
    ani.log_().div_(ksize).add_(1.0)
    ani.masked_fill_(ani.isnan(), 0.0)
    return ani.clamp_(0.0, 1.0).mul_(100.0)


def topk_desc(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top k of each row of float32 x [N, M], as ``jax.lax.top_k``: values
    descending, and among equal values the lower position first, both in
    the order and in which tied elements make the cut. ``torch.topk``
    promises no tie order, so it runs on int64 keys that hold the value's
    order in the high half and M - 1 - position in the low half, all
    distinct. Returns (values [N, k], positions int64 [N, k]). x is made
    contiguous first: a top-k along a strided dimension (the transpose of a
    [M, N] ANI tile) reads with a stride of N and is far slower."""
    x = x.contiguous()
    b = x.view(torch.int32)
    key = b >> 31
    key &= 0x7FFFFFFF
    key ^= b  # float order as signed int order (negatives flipped)
    key = key.to(torch.int64)
    key <<= 32
    key += torch.arange(x.shape[1] - 1, -1, -1, device=x.device)
    pos = torch.topk(key, k, dim=1).indices
    return torch.gather(x, 1, pos), pos


def ani_matrix(r_hv, norm2_r, q_hv, norm2_q, ksize: int,
               mode=True) -> torch.Tensor:
    """Full [M, N] ANI%% matrix from int16 HVs (r_hv may be presplit)."""
    dot = dot_i16_any(r_hv, q_hv, mode)
    return ani_from_dot_matrix(dot, norm2_r, norm2_q, ksize)


def ani_topk(r_hv, norm2_r, q_hv, norm2_q, ksize: int, k_top: int,
             mode=True):
    """Per-query top-k (ANI, ref index, exact dot): the `search` primitive.

    Returns (ani [N, k_top] float32, idx [N, k_top] int32, dot [N, k_top]
    int32), rows are queries, ranked as ``jax.lax.top_k`` ranks (topk_desc).
    The int32 dots are exact (mod 2^32); the TSV recomputes ANI from them
    with the host float chain, so `search` rows print as `dist` rows do.
    """
    dot = dot_i16_any(r_hv, q_hv, mode)
    ani = ani_from_dot_matrix(dot, norm2_r, norm2_q, ksize)
    vals, pos = topk_desc(ani.T, k_top)
    del ani
    return vals, pos.to(torch.int32), torch.gather(dot.T, 1, pos)


def dot_threshold_compact(
    r_hv, norm2_r: torch.Tensor, q_hv: torch.Tensor, norm2_q: torch.Tensor,
    threshold: float, ksize: int, mode=True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dot tile, ANI filter and compaction on the device.

    Keeps the pairs whose device ANI is at least threshold - 0.01 (the JAX
    package's margin for float drift against the host chain). Returns
    (flat index int64 [K] into the [M, N] tile, exact int32 dot [K]). r_hv
    may be presplit.
    """
    dot = dot_i16_any(r_hv, q_hv, mode)
    ani = ani_from_dot_matrix(dot, norm2_r, norm2_q, ksize)
    keep = ani >= torch.tensor(threshold, dtype=torch.float32) - 0.01
    idx = keep.reshape(-1).nonzero().squeeze(-1)
    return idx, dot.reshape(-1)[idx]
