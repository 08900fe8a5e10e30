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
from typing import Sequence, Tuple

import torch

from hypergen_tpu_torch.ops.encode import encode_hv, hv_norm2_i32, hv_to_i16

PLAIN_BLOCK = 512  # hashes per block of the plain encode: bounds [B, n, D]
MAX_ROWS = 65535  # the kernel's grid takes a row per z index


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
    if h.shape[0] > MAX_ROWS:
        raise ValueError(f"at most {MAX_ROWS} rows, got {h.shape[0]}")


def _plain(h, valid, hv_d):
    hv16 = hv_to_i16(encode_hv(h, valid, hv_d, block=PLAIN_BLOCK))
    return hv16, hv_norm2_i32(hv16)


@functools.lru_cache(maxsize=None)
def _entry():
    """The kernel's C entry point, built and bound on first use."""
    from hypergen_tpu_torch.ops.kernels import build

    fn = build.load("encode_kernel").hg_encode_hv_i16
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    return fn


def encode_outputs(B: int, hv_d: int, device):
    """(scratch, hv16, norm2) for a launch: the u32 accumulator and valid
    counts [B*hv_d + B] (zeroed by the launch itself) and the outputs, all
    uninitialised."""
    return (torch.empty(B * hv_d + B, dtype=torch.int32, device=device),
            torch.empty((B, hv_d), dtype=torch.int16, device=device),
            torch.empty((B,), dtype=torch.int32, device=device))


def launch(outs, h, valid, hv_d):
    """Launch the encode into outs (from encode_outputs) on the current
    stream; returns (hv16, norm2). Nothing is read back from the card."""
    fn = _entry()
    scratch, hv16, norm2 = outs
    B, N = h.shape
    dev = h.device
    with torch.cuda.device(dev):
        err = fn(h.data_ptr(), valid.data_ptr(), B, N, hv_d,
                 scratch.data_ptr(), hv16.data_ptr(), norm2.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"encode kernel launch failed: CUDA error {err}")
    if B > 0:  # the C entry launches nothing for no rows
        encode_hv_i16.launches += 1
    return hv16, norm2


def _cuda(h, valid, hv_d):
    return launch(encode_outputs(h.shape[0], hv_d, h.device), h, valid, hv_d)


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
