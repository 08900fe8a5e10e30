"""The PyTorch port's Sketcher against the JAX package's, on the CPU.

The JAX side runs both as its CPU default (use_pallas=False, the XLA path
with exact validity) and through its production packed path with the Pallas
kernel in interpret mode. Tolerance: equal hv bytes, norm2 and n_hashes.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypergen_tpu import params as jax_params
from hypergen_tpu.models import sketcher as jax_sketcher
from hypergen_tpu_torch.io.fastx import INVALID, packed_from_codes
from hypergen_tpu_torch.models import sketcher as ts
from hypergen_tpu_torch.params import SketchParams
from hypergen_tpu_torch.ops.kernels.hash_kernel import hash_packed_rows


def _random_genome(rng, L, n_runs=3):
    codes = rng.integers(0, 4, size=L).astype(np.uint8)
    for _ in range(n_runs):
        s = int(rng.integers(0, max(L - 50, 1)))
        codes[s : s + int(rng.integers(1, 40))] = INVALID
    return codes


def _jaxp(p):
    """The JAX package's SketchParams equal to the port's p."""
    return jax_params.SketchParams(**dataclasses.asdict(p))


def _jax(p, genomes, C, **kw):
    sk = jax_sketcher.Sketcher(_jaxp(p), chunk_positions=C,
                               batch=len(genomes), **kw)
    return sk.collect_batch(sk.submit_batch(genomes))


def _port(p, genomes, C):
    sk = ts.Sketcher(p, device="cpu", chunk_positions=C, batch=len(genomes))
    return sk.sketch_batch([packed_from_codes(g) for g in genomes])


def _assert_same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a["n_hashes"] == b["n_hashes"]
        assert a["norm2"] == b["norm2"]
        np.testing.assert_array_equal(a["hv"], np.asarray(b["hv"]))


def _short_batch():
    rng = np.random.default_rng(11)
    genomes = [_random_genome(rng, L) for L in (5000, 2047, 100, 15)]
    genomes.append(np.full(30, INVALID, np.uint8))  # all-N genome
    return genomes


@pytest.mark.parametrize("scaled", [3, 50])
def test_matches_jax_xla(scaled):
    p = SketchParams(scaled=scaled, hv_d=1024)
    genomes = _short_batch()
    got = _port(p, genomes, 2048)
    _assert_same(got, _jax(p, genomes, 2048, use_pallas=False))
    assert got[0]["n_hashes"] > 0 and got[-1]["n_hashes"] == 0


def test_matches_jax_packed_interpret():
    p = SketchParams(scaled=50, hv_d=1024)
    genomes = _short_batch()
    _assert_same(
        _port(p, genomes, 2048),
        _jax(p, genomes, 2048, use_pallas=True, pallas_interpret=True),
    )


def test_many_invalid_runs_no_run_cap():
    """More than 512 invalid runs: the JAX package leaves its packed path
    for a dense mask; the port has no run cap and keeps the packed path."""
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, size=40000).astype(np.uint8)
    codes[rng.choice(40000, size=900, replace=False)] = INVALID
    g = packed_from_codes(codes)
    assert g.runs.shape[0] > 512
    genomes = [codes, _random_genome(rng, 3000)]
    p = SketchParams(scaled=20, hv_d=512)
    _assert_same(_port(p, genomes, 4096),
                 _jax(p, genomes, 4096, use_pallas=False))


def test_cell_cap_ladder_matches_jax():
    """A tandem repeat whose k-mer passes scaled=50 fills every cell it
    covers past the initial slot cap; the ladder reruns K1 with more slots
    and the sketch still equals the JAX package's."""
    rng = np.random.default_rng(8)
    p = SketchParams(scaled=50, hv_d=512)
    rep = np.tile(np.array([0, 0, 1, 1], np.uint8), 600)  # (AACC)n
    g0 = _random_genome(rng, 9000)
    g0[3000 : 3000 + rep.size] = rep
    genomes = [g0, _random_genome(rng, 5000)]
    C = 4096
    sk = ts.Sketcher(p, device="cpu", chunk_positions=C)
    host = sk._prepare_batch([packed_from_codes(g) for g in genomes], 4)
    *_, cell_max = hash_packed_rows(
        torch.from_numpy(host.words), torch.from_numpy(host.n_pos), 4, C,
        p.ksize,
        p.seed, p.threshold, cells=sk.cells, cap=sk.cell_cap,
    )
    assert int(cell_max.max()) > sk.cell_cap  # the ladder must climb
    _assert_same(_port(p, genomes, C), _jax(p, genomes, C, use_pallas=False))


def test_run_postfilter_matches_jax_dense_form():
    rng = np.random.default_rng(2)
    k = 21
    runs = np.full((3, 7, 2), 0x7FFFFFFF, np.int32)
    for b, n in enumerate((7, 3, 0)):
        bounds = np.sort(rng.choice(5000, size=2 * n, replace=False))
        runs[b, :n] = bounds.reshape(n, 2)
    pos = rng.integers(0, 5000, size=(3, 400)).astype(np.int32)
    pos[:, :5] = [0, 4999, 21, 22, 1]
    got = ts.filter_positions_by_runs(
        torch.from_numpy(pos), torch.from_numpy(runs), k)
    want = jax_sketcher.filter_positions_by_runs(
        jnp.asarray(pos), jnp.asarray(runs), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_geometry_helpers_match_jax():
    for C in (2048, 4096, 1 << 14, 1 << 15, 1 << 17):
        assert ts.packed_cells(C) == jax_sketcher.packed_cells(C)
        for nc in (1, 4, 32):
            assert ts.packed_row_words(nc, C) == jax_sketcher.packed_row_words(
                nc, C)
    p = SketchParams()
    a = ts.Sketcher(p, device="cpu")
    b = jax_sketcher.Sketcher(_jaxp(p), use_pallas=True)
    assert a.cell_cap == b.cell_cap
    for L in (21, 22, 1 << 17, (1 << 17) + 21, 4_194_304, 4_194_305 + 20):
        assert a._bucket(L) == b._bucket(L)
