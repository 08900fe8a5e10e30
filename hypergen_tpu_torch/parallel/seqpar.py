"""Single-genome sequence parallelism: one genome's chunk axis over devices.

Counterpart of ``hypergen_tpu.parallel.seqpar``. The reference handles any
genome length by chunking k-mers per CUDA thread with a k-1 halo
(reference:src/cuda_kernel.cu:31,39-40); here the chunks of one huge genome
are split over a list of ``torch.device``s, so its sketch latency scales
with the device count.

The JAX version is one ``shard_map`` program over a 1-D ``seq`` mesh. Here
one process walks the shards, and the collectives become explicit copies:

  chunks [n_chunks, C + k - 1], split into equal shards along the chunk axis
    -> per shard, on its device: K2 (``hash_chunks``, position-dense
       hashes, run counter, FracMinHash threshold) and an exact compaction
       of the survivors with their true count
    -> the survivors of every shard copied to devices[0] (the all_gather;
       tiny: ~positions/scaled hashes)
    -> global sort + first-occurrence dedup (duplicates span shards, so the
       dedup is global)
    -> each device encodes an equal slab of the distinct hashes into an
       int16 HV (``encode_hv_i16``, the encode kernel on a card)
    -> the slabs' int16 HVs summed in int32 on devices[0] and wrapped
       again, + norm^2 (the psum; ``combine_i16``: the bundle is a sum, and
       the wrap is mod 2^16, so the slabs add up exactly)

The compaction sizes its output to the true survivor count, so the JAX
version's ``chunk_cap`` / ``enc_cap`` retry ladder has no counterpart: no
capacity can overflow. A device may appear more than once in the list
(``["cpu"] * 4``, ``[cuda:0] * 4``), which runs the cross-shard merge on
one device. The split stays inside one process: a pod process passes only
its own card (``Sketcher(seqpar_devices=...)``), and a huge genome of its
share takes the one-row batch or the tiled route there. There is no
cross-process seqpar: the JAX package's pod sketch would start one over
the global device count, which the other processes, sketching other files,
never join.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from hypergen_tpu_torch.io.fastx import INVALID
from hypergen_tpu_torch.models.sketcher import distinct_hashes
from hypergen_tpu_torch.ops.compact import compact_masked
from hypergen_tpu_torch.ops.kernels.encode_kernel import (
    combine_i16,
    encode_hv_i16,
)
from hypergen_tpu_torch.ops.kernels.hash_kernel import hash_chunks
from hypergen_tpu_torch.params import SketchParams


def _chunk_codes(codes: np.ndarray, ksize: int, C: int, n_seq: int) -> np.ndarray:
    """Host: flat base codes -> [n_chunks, C + k - 1] with k-1 halos.

    n_chunks is padded to a multiple of n_seq (whole padding chunks are
    INVALID, contributing nothing).
    """
    n_pos = max(codes.shape[0] - ksize + 1, 1)
    n_chunks = -(-n_pos // C)
    n_chunks = -(-n_chunks // n_seq) * n_seq
    L_ext = n_chunks * C + ksize - 1
    buf = np.full(L_ext, INVALID, dtype=np.uint8)
    n = min(codes.shape[0], L_ext)
    buf[:n] = codes[:n]
    # overlapping rows at stride C over the contiguous buffer: a strided
    # view (then one copy) costs output size only, where a fancy-index
    # matrix would be int64 [n_chunks, C+k-1], 8x the data itself
    view = np.lib.stride_tricks.as_strided(
        buf, shape=(n_chunks, C + ksize - 1),
        strides=(C * buf.strides[0], buf.strides[0]),
    )
    return np.ascontiguousarray(view)


def _default_devices() -> List[torch.device]:
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError(
            "sequence-parallel sketch: no CUDA device (pass devices=['cpu'])"
        )
    return [torch.device("cuda", i) for i in range(n)]


def _shard_survivors(shard: np.ndarray, device: torch.device,
                     p: SketchParams) -> torch.Tensor:
    """K2 over one shard's chunks, then its survivors: int64 [1, n]."""
    h, keep = hash_chunks(
        torch.from_numpy(shard).to(device), p.ksize, p.seed, p.threshold,
        canonical=p.canonical, method=p.sketch_method,
    )
    (surv,), _ = compact_masked(keep.reshape(1, -1), h.reshape(1, -1))
    return surv  # unfilled tail slots hold -1, which distinct_hashes drops


def sketch_codes_seqpar(
    codes: np.ndarray,
    params: SketchParams,
    devices: Optional[Sequence] = None,
    chunk_positions: int = 1 << 17,
) -> Dict[str, object]:
    """Sketch ONE genome with its chunk axis split over ``devices``.

    codes: uint8 [L] flat base codes (0..3, INVALID=4). devices: one entry
    per shard, repeats allowed; default every CUDA card. Returns {"hv":
    int16 [D] numpy, "norm2": int, "n_hashes": int}, bit-identical to the
    Sketcher's one-shot step and to the JAX package's seqpar.
    """
    params.validate()
    devs = [torch.device(d) for d in (
        devices if devices is not None else _default_devices())]
    if not devs:
        raise ValueError("need at least one device")
    n_seq = len(devs)
    chunks = _chunk_codes(codes, params.ksize, int(chunk_positions), n_seq)
    per = chunks.shape[0] // n_seq
    home = devs[0]
    # every shard's survivors, gathered on the first device
    gathered = torch.cat([
        _shard_survivors(chunks[i * per : (i + 1) * per], d, params).to(home)
        for i, d in enumerate(devs)
    ], dim=1)
    hs, first = distinct_hashes(gathered, gathered != -1)
    (uniq,), n_hashes = compact_masked(first, hs)
    n = int(n_hashes[0])
    slab = max(-(-n // n_seq), 1)
    encoded = []
    for i, d in enumerate(devs):  # an empty slab encodes to zeros
        part = uniq[:, i * slab : min((i + 1) * slab, n)].to(d)
        encoded.append(encode_hv_i16(
            part, torch.ones_like(part, dtype=torch.bool), params.hv_d))
    hv16, norm2 = combine_i16([hv.to(home) for hv, _ in encoded])
    return {
        "hv": hv16[0].cpu().numpy(),
        "norm2": int(norm2[0]),
        "n_hashes": n,
    }
