"""Single-device huge-genome tiling in the port, against the JAX package.

``Sketcher.sketch_packed_tiled`` streams fixed-size tiles through the K1
step, unions the per-tile distinct survivor sets on the host and encodes
the union once. Dedup composes as set union and the bundle as a sum, so the
result must equal the JAX package's tiled route and the port's one-shot
step bit for bit: tiles whose boundary cuts an invalid run, duplicates
across tiles, a partial tail tile, and the routing of ``sketch_files``.
Mirrors tests/test_tiled_huge.py. Tolerance 0.
"""

import dataclasses

import numpy as np
import pytest
import torch

from hypergen_tpu import params as jax_params
from hypergen_tpu.models.sketcher import Sketcher as JaxSketcher
from hypergen_tpu_torch.io.fastx import (
    INVALID,
    PackedGenome,
    packed_from_codes,
)
from hypergen_tpu_torch.params import SketchParams
from hypergen_tpu_torch.models import sketcher as ts
from hypergen_tpu_torch.parallel import seqpar

HV_D = 256
SCALED = 40
C = 2048


def _genome(rng, bp, n_runs=3):
    codes = rng.integers(0, 4, size=bp).astype(np.uint8)
    for _ in range(n_runs):
        s = int(rng.integers(0, bp - 60))
        codes[s : s + int(rng.integers(3, 50))] = INVALID
    return codes


def _assert_same(a, b):
    np.testing.assert_array_equal(a["hv"], np.asarray(b["hv"]))
    assert a["norm2"] == int(b["norm2"])
    assert a["n_hashes"] == int(b["n_hashes"])


def _jax(p, **kw):
    """The JAX package's Sketcher, with SketchParams equal to the port's p."""
    return JaxSketcher(jax_params.SketchParams(**dataclasses.asdict(p)),
                       chunk_positions=C, batch=2, **kw)


def _port(p, **kw):
    return ts.Sketcher(p, device="cpu", chunk_positions=C, batch=2, **kw)


def _check(codes, p, tile_chunks, **jax_kw):
    """Port tiled == JAX tiled == port one-shot; returns the result."""
    g = packed_from_codes(codes)
    sk = _port(p)
    got = sk.sketch_packed_tiled(g, tile_chunks=tile_chunks)
    want = _jax(p, **jax_kw).sketch_packed_tiled(g, tile_chunks=tile_chunks)
    _assert_same(got, want)
    _assert_same(got, sk.sketch_batch([g])[0])
    return got


@pytest.mark.parametrize("tile_chunks", [1, 3, 8])
def test_tiled_matches_jax_and_one_shot(tile_chunks):
    # 50,000 bp = 25 chunks of 2048: 3-chunk tiles leave a partial tail
    rng = np.random.default_rng(21)
    p = SketchParams(hv_d=HV_D, scaled=SCALED)
    assert _check(_genome(rng, 50_000), p, tile_chunks)["n_hashes"] > 0


def test_tiled_run_straddles_tile_boundary():
    # an invalid run across the tile edge kills windows in BOTH tiles (each
    # tile carries its clipped run and the k-1 halo)
    rng = np.random.default_rng(22)
    p = SketchParams(hv_d=HV_D, scaled=SCALED)
    codes = rng.integers(0, 4, size=16_384).astype(np.uint8)
    codes[4090:4110] = INVALID  # 2-chunk tiles: the edge is at 4096
    tiles = _port(p)._tile_genome(packed_from_codes(codes), 2)
    assert tiles[0].runs.tolist() == [[4090, 4110]]
    assert tiles[1].runs.tolist() == [[0, 14]]
    _check(codes, p, 2)


def test_tiled_duplicate_kmers_across_tiles():
    # the same k-mers in several tiles encode ONCE (host set union)
    rng = np.random.default_rng(23)
    p = SketchParams(hv_d=HV_D, scaled=4)  # dense survivors
    block = rng.integers(0, 4, size=3000).astype(np.uint8)
    codes = np.concatenate(
        [block, rng.integers(0, 4, size=1600).astype(np.uint8), block, block])
    got = _check(codes, p, 1)
    per_tile = sum(
        ts.Sketcher(p, device="cpu", chunk_positions=C)
        .sketch_batch([t])[0]["n_hashes"]
        for t in _port(p)._tile_genome(packed_from_codes(codes), 1)
    )
    assert got["n_hashes"] < per_tile  # duplicates were merged


def test_tiled_matches_jax_packed_interpret():
    # the JAX side's TPU input format: the packed Pallas step in interpret
    # mode through its probe="hashes" branch
    rng = np.random.default_rng(24)
    p = SketchParams(hv_d=HV_D, scaled=SCALED)
    _check(_genome(rng, 20_000, n_runs=2), p, 2, use_pallas=True,
           pallas_interpret=True)


def test_tiny_genome_one_tile():
    p = SketchParams(hv_d=HV_D, scaled=SCALED)
    for codes in (np.zeros(0, np.uint8), np.arange(15, dtype=np.uint8) % 4,
                  np.arange(300, dtype=np.uint8) % 4):
        g = packed_from_codes(codes)
        sk = _port(p)
        assert len(sk._tile_genome(g, 1)) == 1
        _assert_same(sk.sketch_packed_tiled(g, 1), sk.sketch_batch([g])[0])


def test_sketch_files_routes_tiled_on_one_device(tmp_path, monkeypatch):
    rng = np.random.default_rng(25)
    p = SketchParams(hv_d=HV_D, scaled=SCALED)
    codes = _genome(rng, 40_000)
    seq = np.frombuffer(b"ACGT", np.uint8)[np.where(codes < 4, codes, 0)]
    seq[codes >= 4] = ord("N")
    f = tmp_path / "huge.fna"
    f.write_bytes(b">g\n" + seq.tobytes() + b"\n")
    small = tmp_path / "small.fna"
    small.write_bytes(b">s\n" + seq[:3000].tobytes() + b"\n")

    sk = _port(p, seqpar_min_chunks=16)  # 40,000 bp -> a 32-chunk bucket
    called = []
    orig = sk._tile_genome
    monkeypatch.setattr(
        sk, "_tile_genome",
        lambda g, tile_chunks: called.append(tile_chunks) or orig(
            g, tile_chunks),
    )
    out = sk.sketch_files([f, small])
    assert called == [2]  # one tiled genome, seqpar_min_chunks // 8 chunks
    want = _jax(p).sketch_files([f, small], progress=False)
    for a, b in zip(out, want):
        np.testing.assert_array_equal(a.decompress(), b.decompress())
        assert a.hv_norm_2 == b.hv_norm_2


GIB = 1 << 30
MAX = ts.MAX_POSITIONS


@pytest.mark.parametrize("device,cards,free,length,route", [
    # the CPU routes as the JAX package: tiled, whatever the memory
    ("cpu", 4, 80 * GIB, 3000, "tiled"),
    # CUDA: the one-row batch wherever it fits, on one card or several
    ("cuda", 1, 80 * GIB, 3000, "one-row"),
    ("cuda", 2, 80 * GIB, 3000, "one-row"),
    # past the memory estimate: tiled on one card, seqpar on several
    ("cuda", 1, 1 * GIB, 3000, "tiled"),
    ("cuda", 2, 1 * GIB, 3000, "seqpar"),
    # past the int32 positions: a genome of 2^31 codes
    ("cuda", 1, 80 * GIB, MAX, "tiled"),
    ("cuda", 4, 80 * GIB, MAX, "seqpar"),
    # the longest genome the one-row batch takes: 2^31 - 1 codes
    ("cuda", 1, 80 * GIB, MAX - 1, "one-row"),
])
def test_huge_genome_route(monkeypatch, device, cards, free, length, route):
    """On a CUDA Sketcher the one-row batch while it fits K1's int32
    positions and the card's free memory, then seqpar with more than one
    card and tiled with one; on the CPU tiled, as the JAX package routes.
    Every route is stubbed, so a genome's length alone steers it."""
    p = SketchParams(hv_d=HV_D, scaled=SCALED)
    sk = _port(p, seqpar_min_chunks=16)
    sk.device = torch.device(device)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev=None: (free, 80 * GIB))
    monkeypatch.setattr(ts, "codes_from_packed", lambda g: None)
    seen = []
    monkeypatch.setattr(sk, "sketch_batch",
                        lambda gs: seen.append("one-row") or [None])
    monkeypatch.setattr(sk, "sketch_packed_tiled",
                        lambda g: seen.append("tiled"))
    monkeypatch.setattr(seqpar, "sketch_codes_seqpar",
                        lambda codes, params, devices, chunk_positions:
                        seen.append("seqpar" if len(devices) == cards
                                    else f"seqpar on {devices}"))
    # 3000 bp: a 2-chunk bucket of 2048 positions
    sk._sketch_huge(PackedGenome(np.zeros(1, np.uint8),
                                 np.zeros((0, 2), np.int32), length))
    assert seen == [route]


def test_one_row_estimate_scales_with_cap(monkeypatch):
    """The memory estimate is the packed words plus ONE_ROW_BYTES_PER_SLOT
    for each slot, so it grows with the bucket and with the cell cap; the
    router doubles it and keeps the reserve free."""
    p = SketchParams(hv_d=HV_D, scaled=SCALED)
    sk = _port(p)
    per_chunk = C // 4 + sk.cells * sk.cell_cap * ts.ONE_ROW_BYTES_PER_SLOT
    assert sk._one_row_bytes(8) == 8 * per_chunk
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev=None: (2 * per_chunk + ts.ONE_ROW_RESERVE,
                                          80 * GIB))
    assert sk._one_row_fits(C) and not sk._one_row_fits(C + 100)  # 1, 2 chunks
    sk.cell_cap *= 4
    assert not sk._one_row_fits(C)


def test_run_postfilter_at_int32_limit():
    """The last windows of the longest genome the router sends to the
    one-row batch (2^31 - 1 codes): with no runs (only the padding row,
    which starts at INT32_MAX) every window is kept; a run at the genome's
    end drops exactly the windows that overlap it."""
    k = 21
    L = MAX - 1
    pos = torch.arange(L - k - 40, L - k + 1, dtype=torch.int32)[None]
    pad = torch.full((1, 1, 2), 0x7FFFFFFF, dtype=torch.int32)
    assert bool(ts.filter_positions_by_runs(pos, pad, k).all())
    run = (L - 30, L - 25)
    runs = torch.cat([torch.tensor([[run]], dtype=torch.int32), pad], dim=1)
    got = ts.filter_positions_by_runs(pos, runs, k)[0].tolist()
    want = [not (p < run[1] and run[0] < p + k) for p in pos[0].tolist()]
    assert got == want and not all(want) and any(want)
