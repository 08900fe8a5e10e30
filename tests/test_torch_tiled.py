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
from hypergen_tpu_torch.io.fastx import INVALID, packed_from_codes
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


@pytest.mark.parametrize("device,cards,route", [
    ("cpu", 4, "tiled"), ("cuda", 1, "tiled"), ("cuda", 2, "seqpar")])
def test_huge_genome_route(monkeypatch, device, cards, route):
    """seqpar only on a CUDA Sketcher with more than one card, as the JAX
    package routes by its device count."""
    p = SketchParams(hv_d=HV_D, scaled=SCALED)
    sk = _port(p, seqpar_min_chunks=16)
    sk.device = torch.device(device)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    seen = []
    monkeypatch.setattr(sk, "sketch_packed_tiled",
                        lambda g: seen.append("tiled"))
    monkeypatch.setattr(seqpar, "sketch_codes_seqpar",
                        lambda codes, params, chunk_positions:
                        seen.append("seqpar"))
    sk._sketch_huge(packed_from_codes(np.zeros(100, np.uint8)))
    assert seen == [route]
