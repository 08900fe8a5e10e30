"""The HV encode kernel: its wrapper and its plain version.

``encode_hv_i16(h, valid, hv_d)`` computes, per row, what
``hv_norm2_i32(hv_to_i16(encode_hv(h, valid, hv_d)))`` computes
(``ops.encode``): the wyrng bundle of the row's valid hashes, wrapped to
int16, and its wrapping-int32 norm². It is the counterpart of the XLA code
that the JAX package fuses into its sketch step, its tiled route and its
sequence-parallel encode (``hypergen_tpu.ops.encode``); there is no Pallas
kernel behind it. The kernel lives in ``csrc/encode_kernel.cu`` and runs
for a CUDA tensor; the plain version runs for a CPU tensor. A CUDA tensor
never reaches the plain version: if the kernel cannot be built or
launched, the call raises.

Partial HVs of disjoint hash sets (the sequence-parallel slabs) combine in
``combine_i16``: their int16 values summed in int32 and wrapped once more,
which equals the int16 wrap of the summed int32 HVs (both are the sum mod
2^16).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Sequence, Tuple

import torch

from hypergen_tpu_torch.ops.encode import encode_hv, hv_norm2_i32, hv_to_i16

PLAIN_BLOCK = 512  # hashes per block of the plain encode: bounds [B, n, D]
MAX_ROWS = 65535  # the kernel's grid takes a row per z index
# The kernel's geometry (csrc/encode_kernel.cu, checked against its
# hg_encode_geometry when the kernel is loaded): a block takes one row, one
# word group of GROUP_DIMS dimensions and one slab of the row's tiles of
# TILE hash slots (every S-th tile). The slabs are chosen here: MIN_TILES
# tiles a slab at least, at most MAX_SLABS a row, and no more than
# MAX_BLOCKS blocks in all unless one slab a row already gives more.
TILE = 128
GROUP_DIMS = 512
MAX_GROUPS = 65535  # the grid's y dimension
MAX_SLABS = 64
MIN_TILES = 8
MAX_BLOCKS = 2048


def _check(h: torch.Tensor, valid: torch.Tensor, hv_d: int) -> None:
    """Raise on any call the kernel does not take."""
    if h.dtype != torch.int64 or h.dim() != 2:
        raise ValueError("h must be int64 [B, N] (u64 bits)")
    if valid.dtype != torch.bool or valid.shape != h.shape:
        raise ValueError("valid must be bool [B, N], the shape of h")
    if valid.device != h.device:
        raise ValueError("h and valid must share a device")
    if not (h.is_contiguous() and valid.is_contiguous()):
        raise ValueError("h and valid must be contiguous")
    if hv_d < 64 or hv_d % 64 != 0:
        raise ValueError(f"hv_d must be a positive multiple of 64, got {hv_d}")
    if word_groups(hv_d) > MAX_GROUPS:
        raise ValueError(f"hv_d above {MAX_GROUPS * GROUP_DIMS}: {hv_d}")
    if h.shape[0] > MAX_ROWS:
        raise ValueError(f"at most {MAX_ROWS} rows, got {h.shape[0]}")


def word_groups(hv_d: int) -> int:
    """G: the word groups of GROUP_DIMS dimensions that cover hv_d."""
    return -(-hv_d // GROUP_DIMS)


def slab_plan(B: int, N: int, hv_d: int) -> int:
    """S, the slabs of a row of N slots, for a launch of S * G * B blocks;
    slab s takes tiles s, s + S, ... S is 1 when the row has fewer than
    2 * MIN_TILES tiles (N = 0 too: the one launch still writes the zero
    HVs)."""
    tiles = -(-N // TILE)
    rows = max(1, B * word_groups(hv_d))
    return max(1, min(MAX_SLABS, tiles // MIN_TILES, MAX_BLOCKS // rows))


def scratch_words(B: int, S: int, hv_d: int) -> int:
    """u32 words of a launch's scratch for S slabs a row: each block's sums
    of its word group's dimensions, [B, G, S, GROUP_DIMS], and each word
    group's sum of squares, [B, G]."""
    return B * word_groups(hv_d) * (S * GROUP_DIMS + 1)


# the tickets of the kernel's merge, one int32 buffer per (device, stream):
# zeroed when made or grown, and left zero by every launch
_tickets: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def ticket_buffer(B: int, hv_d: int, device, stream: int) -> torch.Tensor:
    """The ticket buffer of (device, stream) with room for B rows at hv_d,
    made (or grown to the next power of two) with zeros on the current
    stream when it is missing or too small. Nothing is read back."""
    if not isinstance(device, torch.device) or device.index is None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    key = (device, stream)
    need = B * (word_groups(hv_d) + 1)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < need:
        buf = torch.zeros(1 << max(need - 1, 1).bit_length(),
                          dtype=torch.int32, device=device)
        _tickets[key] = buf
    return buf


def _plain(h, valid, hv_d):
    hv16 = hv_to_i16(encode_hv(h, valid, hv_d, block=PLAIN_BLOCK))
    return hv16, hv_norm2_i32(hv16)


@functools.lru_cache(maxsize=None)
def _entry():
    """The kernel's C entry point, built and bound on first use; raises if
    the kernel's geometry is not the one this module plans for."""
    from hypergen_tpu_torch.ops.kernels import build

    lib = build.load("encode_kernel")
    geometry = (ctypes.c_int * 3)()
    lib.hg_encode_geometry(geometry)
    if tuple(geometry) != (TILE, GROUP_DIMS, MAX_SLABS):
        raise RuntimeError(f"encode kernel geometry {tuple(geometry)} != "
                           f"{(TILE, GROUP_DIMS, MAX_SLABS)}")
    fn = lib.hg_encode_hv_i16
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    return fn


def encode_outputs(B: int, N: int, hv_d: int, device):
    """(S, scratch, hv16, norm2) for a launch over B rows of N slots: the
    slab plan, the u32 scratch of scratch_words and the outputs, all
    uninitialised."""
    S = slab_plan(B, N, hv_d)
    return (S,
            torch.empty(scratch_words(B, S, hv_d), dtype=torch.int32,
                        device=device),
            torch.empty((B, hv_d), dtype=torch.int16, device=device),
            torch.empty((B,), dtype=torch.int32, device=device))


def launch(outs, h, valid, hv_d):
    """Launch the encode into outs (from encode_outputs for h's shape) on
    the current stream, with that stream's ticket buffer; returns (hv16,
    norm2). One kernel for B > 0, none for B = 0; nothing is read back
    from the card. The C entry refuses a scratch too small for the plan."""
    fn = _entry()
    S, scratch, hv16, norm2 = outs
    B, N = h.shape
    dev = h.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        tickets = ticket_buffer(B, hv_d, dev, stream)
        err = fn(h.data_ptr(), valid.data_ptr(), B, N, hv_d, S,
                 scratch.data_ptr(), scratch.numel(), tickets.data_ptr(),
                 tickets.numel(), hv16.data_ptr(), norm2.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"encode kernel launch failed: CUDA error {err}")
    if B > 0:  # the C entry launches nothing for no rows
        encode_hv_i16.launches += 1
    return hv16, norm2


def _cuda(h, valid, hv_d):
    return launch(encode_outputs(*h.shape, hv_d, h.device), h, valid, hv_d)


def _for(device: torch.device):
    """The kernel for a CUDA device, the plain version for the CPU; no
    fallback from one to the other."""
    if device.type == "cuda":
        return _cuda
    if device.type == "cpu":
        return _plain
    raise ValueError(f"no encode kernel for device {device}")


def encode_hv_i16(
    h: torch.Tensor, valid: torch.Tensor, hv_d: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bundle each row's valid hashes into an int16 HV with its norm².

    h: int64 [B, N] hashes (u64 bits); valid: bool [B, N], False entries
    contribute nothing; both contiguous, on one device. Returns (hv16 int16
    [B, hv_d], norm2 int32 [B]) = (hv_to_i16(encode_hv(h, valid, hv_d)),
    hv_norm2_i32 of it). Launches the CUDA kernel for a CUDA tensor and the
    plain version for a CPU tensor.
    """
    fn = _for(h.device)
    _check(h, valid, hv_d)
    return fn(h, valid, hv_d)


encode_hv_i16.launches = 0  # CUDA launches, for showing the path ran


def encode_hv_i16_plain(
    h: torch.Tensor, valid: torch.Tensor, hv_d: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of encode_hv_i16, on any device."""
    _check(h, valid, hv_d)
    return _plain(h, valid, hv_d)


def combine_i16(parts: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hv16, norm2) of the union of disjoint hash sets from their int16
    HVs (each [B, D], on one device): summed in int32, wrapped to int16
    again, and its norm². Equal to one encode of the union, since the wrap
    to int16 is the value mod 2^16."""
    total = torch.stack(list(parts)).sum(dim=0, dtype=torch.int32)
    hv16 = hv_to_i16(total)
    return hv16, hv_norm2_i32(hv16)
