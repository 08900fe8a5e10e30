"""The hash kernels K1 and K2: their wrappers and their plain versions.

K1, ``hash_packed_rows``: counterpart of
``hypergen_tpu.ops.pallas.hash_kernel.hash_packed_rows_pallas`` with the
same arguments, cell geometry and output layout, so that with the same
``cells`` every output is bit-identical to the TPU kernel's, slot for slot.

K2, ``hash_chunks``: counterpart of ``hash_chunks_pallas``, position-dense
hashes of code chunks with a k-1 halo, for the sequence-parallel sketch.

Hashes come back as int64 bit patterns instead of (hi, lo) u32 pairs. Both
kernels live in ``csrc/hash_kernel.cu`` and run for a CUDA tensor; the
plain PyTorch versions run for a CPU tensor. A CUDA tensor never reaches a
plain version: if a kernel cannot be built or launched, the call raises.
Each kernel writes every element of its outputs, so a wrapper allocates
them uninitialised and runs no pass after the launch; ``launch_rows`` and
``launch_chunks`` launch into outputs allocated beforehand.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from hypergen_tpu_torch.ops.kmers import hash_kmer_positions
from hypergen_tpu_torch.ops.u64 import U64_MASK

CELLS = 2048  # the packed path's preferred cell count (models.sketcher)
# positions of one K1 row at most: its int32 `pos` holds 0 .. 2^31 - 1
MAX_POSITIONS = 1 << 31


def _check(packed_words, n_pos, n_chunks, chunk_positions, ksize, cells,
           cap) -> None:
    """Raise on any launch the kernel does not take."""
    if packed_words.dtype != torch.int32 or packed_words.dim() != 2:
        raise ValueError("packed_words must be int32 [B, W] (u32 bits)")
    if n_pos.dtype != torch.int32 or n_pos.shape != packed_words.shape[:1]:
        raise ValueError("n_pos must be int32 [B]")
    if n_pos.device != packed_words.device:
        raise ValueError("packed_words and n_pos must share a device")
    if not (packed_words.is_contiguous() and n_pos.is_contiguous()):
        raise ValueError("packed_words and n_pos must be contiguous")
    if not 1 <= ksize <= 32:
        raise ValueError("ksize must be in [1, 32]")
    B, W = packed_words.shape
    C = chunk_positions
    if B < 1 or n_chunks < 1 or cap < 1:
        raise ValueError("need at least one row, one chunk and one slot")
    if cells % 128 != 0:
        raise ValueError(f"cells {cells} must be a multiple of 128")
    if C % (16 * cells) != 0:
        raise ValueError(
            f"chunk positions {C} must be a multiple of 16*cells ({16 * cells})"
        )
    lsub = C // cells
    t_w = -(-(lsub + ksize - 1) // 16)
    need = n_chunks * (C // 16) + t_w - lsub // 16
    if W < need:
        raise ValueError(f"packed row too short: {W} words < {need}")
    if n_chunks * C > MAX_POSITIONS:
        raise ValueError(
            f"{n_chunks} chunks of {C} positions exceed the int32 positions"
        )


def _rows_plain(packed_words, n_pos, n_chunks, C, ksize, seed, threshold,
                canonical, method, cells, cap):
    """Plain PyTorch K1 in the kernel's raw layout.

    Unpacks each row to 2-bit codes, hashes every position with all bases
    taken as valid (the packed path hashes optimistically; the caller's run
    postfilter repairs invalid windows), keeps h < threshold && pos < n_pos,
    ranks the survivors within each cell and scatters them into the same
    [B*n_chunks, cap, cells] slots with the same true counts. One row at a
    time, to bound memory at the production shape.
    """
    B = packed_words.shape[0]
    dev = packed_words.device
    lsub = C // cells
    n = n_chunks * C
    shifts = torch.arange(0, 32, 2, device=dev)
    out_h = torch.full((B * n_chunks, cap, cells), -1, dtype=torch.int64,
                       device=dev)
    out_pos = torch.full((B * n_chunks, cap, cells), -1, dtype=torch.int32,
                         device=dev)
    out_cnt = torch.zeros((B * n_chunks, cells), dtype=torch.int32, device=dev)
    n_words = -(-(n + ksize - 1) // 16)
    for b in range(B):
        w = packed_words[b, :n_words].to(torch.int64)
        codes = ((w[:, None] >> shifts) & 3).reshape(-1)[: n + ksize - 1]
        h, keep = hash_kmer_positions(
            codes, ksize, seed, threshold, canonical=canonical, method=method
        )
        keep &= torch.arange(n, device=dev) < n_pos[b]
        keep = keep.reshape(n_chunks, cells, lsub)
        rank = torch.cumsum(keep, dim=-1, dtype=torch.int32) - 1
        out_cnt[b * n_chunks : (b + 1) * n_chunks] = rank[..., -1] + 1
        put = keep & (rank < cap)
        chunk, cell, t = put.nonzero(as_tuple=True)
        bn = b * n_chunks + chunk
        slot = rank[chunk, cell, t].long()
        out_h[bn, slot, cell] = h.reshape(n_chunks, cells, lsub)[chunk, cell, t]
        out_pos[bn, slot, cell] = (cell * lsub + t).to(torch.int32)
    return _public(out_h, out_pos, out_cnt, B, n_chunks, C, cells, cap)


def _public(out_h, out_pos, out_cnt, B, n_chunks, C, cells, cap):
    """Raw [B*n_chunks, cap, cells] slots with chunk-local positions and
    per-cell counts -> the public (h, pos, valid, cell_max) in the JAX
    launcher's (chunk, slot, cell) order; the CUDA kernel writes these
    directly."""
    S = n_chunks * cap * cells
    h = out_h.reshape(B, S)
    valid = h != -1
    chunk_off = torch.arange(n_chunks, dtype=torch.int32, device=h.device)
    chunk_off = (chunk_off * C).repeat_interleave(cap * cells)
    pos = torch.where(valid, out_pos.reshape(B, S) + chunk_off, -1)
    cell_max = out_cnt.reshape(B, -1).amax(dim=-1)
    return h, pos, valid, cell_max


_ARGTYPES = {
    "hg_hash_packed_rows": [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_ulonglong,
        ctypes.c_ulonglong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
    ],
    "hg_hash_chunks": [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_ulonglong, ctypes.c_ulonglong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ],
}


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """A kernel's C entry point, built and bound on first use."""
    from hypergen_tpu_torch.ops.kernels import build

    fn = getattr(build.load("hash_kernel"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = _ARGTYPES[name]
    return fn


def rows_outputs(B, n_chunks, cells, cap, device):
    """Uninitialised outputs of the K1 kernel, (h, pos, valid, cell_max) as
    hash_packed_rows returns them; cell_max is zeroed, as the kernel needs
    (it takes the maximum in place)."""
    S = n_chunks * cap * cells
    return (
        torch.empty((B, S), dtype=torch.int64, device=device),
        torch.empty((B, S), dtype=torch.int32, device=device),
        torch.empty((B, S), dtype=torch.bool, device=device),
        torch.zeros((B,), dtype=torch.int32, device=device),
    )


def launch_rows(outs, packed_words, n_pos, n_chunks, C, ksize, seed,
                threshold, canonical, method, cells, cap):
    """Launch the K1 kernel into `outs` (from rows_outputs, cell_max zeroed)
    on the current stream; every element of outs is written."""
    fn = _entry("hg_hash_packed_rows")
    B, W = packed_words.shape
    dev = packed_words.device
    with torch.cuda.device(dev):
        err = fn(
            packed_words.data_ptr(), W, n_pos.data_ptr(), B, n_chunks, C,
            ksize, seed & U64_MASK, threshold, int(canonical),
            int(method == "mmhash"), cells, cap,
            *(t.data_ptr() for t in outs),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"hash kernel launch failed: CUDA error {err}")
    hash_packed_rows.launches += 1
    return outs


def _rows_cuda(packed_words, n_pos, n_chunks, C, ksize, seed, threshold,
               canonical, method, cells, cap):
    """Launch csrc/hash_kernel.cu; the kernel writes the public outputs
    (sentinels, chunk offsets and cell_max included), so no pass follows."""
    outs = rows_outputs(packed_words.shape[0], n_chunks, cells, cap,
                        packed_words.device)
    return launch_rows(outs, packed_words, n_pos, n_chunks, C, ksize, seed,
                       threshold, canonical, method, cells, cap)


def hash_packed_rows(
    packed_words: torch.Tensor,
    n_pos: torch.Tensor,
    n_chunks: int,
    chunk_positions: int,
    ksize: int,
    seed: int,
    threshold: int,
    canonical: bool = True,
    method: str = "t1ha2",
    cells: int = CELLS,
    cap: int = 4,
):
    """Fused front half of the sketch step straight from packed rows.

    packed_words: int32 [B, W] holding u32 words of 16 2-bit codes each
      (position p at bits [2*(p%16), +2) of word p//16). Rows cover
      n_chunks*chunk_positions positions plus slack; invalid and padding
      regions may hold any bits.
    n_pos: int32 [B], k-mer positions per genome; positions >= n_pos never
      survive. Everything below is hashed as if valid, and the caller
      postfilters against the genome's invalid runs.

    Returns (h int64 [B, S], pos int32 [B, S] genome-global k-mer start,
    valid bool [B, S], cell_max int32 [B]) with S = n_chunks*cap*cells in
    (chunk, slot, cell) order. Empty slots hold the U64_MAX sentinel (-1)
    and pos -1. cell_max > cap means slot overflow: rerun with a larger
    cap. Launches the CUDA kernel for a CUDA tensor and the plain version
    for a CPU tensor.
    """
    rows_fn = _rows_for(packed_words.device)
    return _run(rows_fn, packed_words, n_pos, n_chunks, chunk_positions,
                ksize, seed, threshold, canonical, method, cells, cap)


hash_packed_rows.launches = 0  # CUDA launches, for showing the path ran


def _rows_for(device: torch.device):
    """The kernel for a CUDA device, the plain version for the CPU; no
    fallback from one to the other."""
    if device.type == "cuda":
        return _rows_cuda
    if device.type == "cpu":
        return _rows_plain
    raise ValueError(f"no hash kernel for device {device}")


def hash_packed_rows_plain(
    packed_words: torch.Tensor,
    n_pos: torch.Tensor,
    n_chunks: int,
    chunk_positions: int,
    ksize: int,
    seed: int,
    threshold: int,
    canonical: bool = True,
    method: str = "t1ha2",
    cells: int = CELLS,
    cap: int = 4,
):
    """The plain PyTorch version of hash_packed_rows, on any device."""
    return _run(_rows_plain, packed_words, n_pos, n_chunks, chunk_positions,
                ksize, seed, threshold, canonical, method, cells, cap)


def _run(rows_fn, packed_words, n_pos, n_chunks, C, ksize, seed, threshold,
         canonical, method, cells, cap):
    if method not in ("t1ha2", "mmhash"):
        raise ValueError(f"unknown sketch method {method!r}")
    _check(packed_words, n_pos, n_chunks, C, ksize, cells, cap)
    return rows_fn(packed_words, n_pos, n_chunks, C, ksize, seed, threshold,
                   canonical, method, cells, cap)


# -- K2 -----------------------------------------------------------------------

PLAIN_POSITIONS = 1 << 22  # k-mer positions per pass of hash_chunks_plain


def _chunks_plain(codes, ksize, seed, threshold, canonical, method):
    """Plain PyTorch K2: hash_kmer_positions with the U64_MAX sentinel
    where a window is not kept, a bounded number of chunks at a time."""
    nc, width = codes.shape
    C = width - ksize + 1
    out_h = torch.empty((nc, C), dtype=torch.int64, device=codes.device)
    out_keep = torch.empty((nc, C), dtype=torch.bool, device=codes.device)
    step = max(1, PLAIN_POSITIONS // C)
    for lo in range(0, nc, step):
        h, keep = hash_kmer_positions(
            codes[lo : lo + step], ksize, seed, threshold,
            canonical=canonical, method=method,
        )
        out_h[lo : lo + step] = torch.where(keep, h, -1)
        out_keep[lo : lo + step] = keep
    return out_h, out_keep


def launch_chunks(outs, codes, ksize, seed, threshold, canonical, method):
    """Launch K2 into outs = (h int64 [nc, C], keep bool [nc, C]) on the
    current stream; every element of outs is written."""
    fn = _entry("hg_hash_chunks")
    nc, width = codes.shape
    dev = codes.device
    with torch.cuda.device(dev):
        err = fn(
            codes.data_ptr(), nc, width - ksize + 1, ksize, seed & U64_MASK,
            threshold, int(canonical), int(method == "mmhash"),
            outs[0].data_ptr(), outs[1].data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"chunk hash kernel launch failed: CUDA error {err}")
    hash_chunks.launches += 1
    return outs


def _chunks_cuda(codes, ksize, seed, threshold, canonical, method):
    """Launch K2 of csrc/hash_kernel.cu; same outputs as _chunks_plain."""
    nc, width = codes.shape
    C = width - ksize + 1
    outs = (torch.empty((nc, C), dtype=torch.int64, device=codes.device),
            torch.empty((nc, C), dtype=torch.bool, device=codes.device))
    return launch_chunks(outs, codes, ksize, seed, threshold, canonical,
                         method)


def _chunks_for(device: torch.device):
    """K2 for a CUDA device, its plain version for the CPU; no fallback
    from one to the other."""
    if device.type == "cuda":
        return _chunks_cuda
    if device.type == "cpu":
        return _chunks_plain
    raise ValueError(f"no chunk hash kernel for device {device}")


def _run_chunks(chunks_fn, codes, ksize, seed, threshold, canonical, method):
    if method not in ("t1ha2", "mmhash"):
        raise ValueError(f"unknown sketch method {method!r}")
    if not 1 <= ksize <= 32:
        raise ValueError("ksize must be in [1, 32]")
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise ValueError("codes must be uint8 [nc, C + k - 1]")
    if not codes.is_contiguous():
        raise ValueError("codes must be contiguous")
    if codes.shape[0] < 1 or codes.shape[1] < ksize:
        raise ValueError(
            f"need at least one chunk of at least k={ksize} codes, "
            f"got {tuple(codes.shape)}"
        )
    return chunks_fn(codes, ksize, seed, threshold, canonical, method)


def hash_chunks(
    codes: torch.Tensor,
    ksize: int,
    seed: int,
    threshold: int,
    canonical: bool = True,
    method: str = "t1ha2",
):
    """Position-dense k-mer hashes of code chunks (K2).

    codes: uint8 [nc, C + k - 1], chunk i's C k-mer starts plus a k-1 halo;
    a code >= 4 is invalid. Returns (h int64 [nc, C], keep bool [nc, C]):
    keep = the window's k codes are valid and h < threshold; where keep is
    false, h holds the U64_MAX sentinel (-1). This is the contract of
    ``hash_chunks_pallas``, sentinel included. Launches the CUDA kernel for
    a CUDA tensor and the plain version for a CPU tensor.
    """
    return _run_chunks(_chunks_for(codes.device), codes, ksize, seed,
                       threshold, canonical, method)


hash_chunks.launches = 0  # CUDA launches, for showing the path ran


def hash_chunks_plain(
    codes: torch.Tensor,
    ksize: int,
    seed: int,
    threshold: int,
    canonical: bool = True,
    method: str = "t1ha2",
):
    """The plain PyTorch version of hash_chunks, on any device."""
    return _run_chunks(_chunks_plain, codes, ksize, seed, threshold,
                       canonical, method)
