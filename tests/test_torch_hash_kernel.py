"""K1, the fused packed hash kernel: the port's plain version against the
JAX Pallas kernel in interpret mode, slot for slot, and the CUDA kernel
against the plain version on the card. Tolerance: exact equality of bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypergen_tpu.models.sketcher import packed_row_words
from hypergen_tpu.ops import u64 as ju
from hypergen_tpu.ops.kmers import hash_kmer_positions
from hypergen_tpu.ops.pallas.hash_kernel import hash_packed_rows_pallas
from hypergen_tpu.params import fracminhash_threshold
from hypergen_tpu_torch.io.fastx import packed_from_codes
from hypergen_tpu_torch.ops import u64 as tu
from hypergen_tpu_torch.ops.kernels import build
from hypergen_tpu_torch.ops.kernels import hash_kernel as hk


def _packed(genomes, nc, C, k):
    """Packed words (u32) and n_pos for both packages from code arrays."""
    W = packed_row_words(nc, C)
    buf = np.zeros((len(genomes), W * 4), np.uint8)
    n_pos = np.zeros(len(genomes), np.int32)
    for b, codes in enumerate(genomes):
        g = packed_from_codes(codes)
        nb = min(g.packed2.shape[0], W * 4)
        buf[b, :nb] = g.packed2[:nb]
        n_pos[b] = max(g.length - k + 1, 0)
    return buf.view(np.uint32), n_pos


def _genomes(rng, lengths, k, n_runs=5):
    out = []
    for n in lengths:
        L = n + k - 1
        codes = rng.integers(0, 4, size=L).astype(np.uint8)
        for _ in range(n_runs):
            s = int(rng.integers(0, L - 50))
            codes[s : s + int(rng.integers(1, 40))] = 4
        out.append(codes)
    return out


def _torch_k1(words, n_pos, *args, **kw):
    h, pos, valid, cell_max = hk.hash_packed_rows(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(n_pos),
        *args, **kw,
    )
    return tu.to_numpy(h), pos.numpy(), valid.numpy(), cell_max.numpy()


CASES = {
    # test_packed_kernel_parity: short genomes, interior N runs, two chunks
    "parity": dict(k=21, nc=2, lengths=[2 * 2048 - 777, 2048 + 5], cap=16),
    # test_packed_kernel_parity_variants
    "mmhash": dict(k=21, nc=1, lengths=[2048 + 300], cap=16, method="mmhash"),
    "noncanonical": dict(k=21, nc=1, lengths=[2048 + 300], cap=16,
                         canonical=False),
    # slots overflow: cell_max > cap, counts stay true
    "overflow": dict(k=21, nc=2, lengths=[2 * 2048, 2048 + 900], cap=1,
                     scaled=2),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_interpret_slot_for_slot(name):
    case = CASES[name]
    k, nc, C, cells = case["k"], case["nc"], 2048, 128
    thr = fracminhash_threshold(case.get("scaled", 3))
    kw = dict(canonical=case.get("canonical", True),
              method=case.get("method", "t1ha2"), cells=cells, cap=case["cap"])
    rng = np.random.default_rng(sorted(CASES).index(name))
    words, n_pos = _packed(_genomes(rng, case["lengths"], k), nc, C, k)
    h, pos, valid, cell_max = hash_packed_rows_pallas(
        jnp.asarray(words), jnp.asarray(n_pos), nc, C, k, 123, thr,
        interpret=True, **kw,
    )
    got = _torch_k1(words, n_pos, nc, C, k, 123, thr, **kw)
    np.testing.assert_array_equal(got[0], ju.to_np_u64(h))
    np.testing.assert_array_equal(got[1], np.asarray(pos))
    np.testing.assert_array_equal(got[2], np.asarray(valid))
    np.testing.assert_array_equal(got[3], np.asarray(cell_max))
    if name == "overflow":
        assert (got[3] > case["cap"]).all()
    else:
        assert (got[3] <= case["cap"]).all() and got[2].any()


@pytest.mark.parametrize("k", [15, 32])
def test_plain_matches_jax_xla_per_cell(k):
    """Every cell's slots hold exactly the kept (hash, position) pairs of
    the JAX XLA path over the same codes, in position order."""
    nc, C, cells, lsub = 2, 2048, 128, 16
    thr = fracminhash_threshold(4)
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, size=nc * C + k - 1).astype(np.uint8)
    words, n_pos = _packed([codes], nc, C, k)
    h, pos, valid, cell_max = _torch_k1(
        words, n_pos, nc, C, k, 123, thr, cells=cells, cap=lsub)
    chunks = np.stack([codes[c * C : c * C + C + k - 1] for c in range(nc)])
    h_ref, keep_ref = hash_kmer_positions(jnp.asarray(chunks), k, 123, thr)
    h_ref = ju.to_np_u64(h_ref).reshape(nc, cells, lsub)
    keep_ref = np.asarray(keep_ref).reshape(nc, cells, lsub)
    h = h[0].reshape(nc, lsub, cells)
    pos = pos[0].reshape(nc, lsub, cells)
    valid = valid[0].reshape(nc, lsub, cells)
    for c in range(nc):
        for cell in range(cells):
            t = np.flatnonzero(keep_ref[c, cell])
            n = t.size
            assert valid[c, :, cell].sum() == n
            np.testing.assert_array_equal(h[c, :n, cell], h_ref[c, cell, t])
            np.testing.assert_array_equal(
                pos[c, :n, cell], c * C + cell * lsub + t)
    assert int(cell_max[0]) == int(keep_ref.sum(-1).max())


def test_cuda_route_never_falls_back(monkeypatch, tmp_path):
    """A CUDA tensor goes to the kernel or raises: with no compiler and no
    built library the call fails, and the plain version is never run."""
    assert hk._rows_for(torch.device("cuda", 0)) is hk._rows_cuda
    assert hk._rows_for(torch.device("cpu")) is hk._rows_plain
    with pytest.raises(ValueError):
        hk._rows_for(torch.device("meta"))

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    def plain_must_not_run(*a, **k):
        raise AssertionError("a CUDA call reached the plain version")

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_nvcc", no_nvcc)
    monkeypatch.setattr(hk, "_rows_plain", plain_must_not_run)
    hk._entry.cache_clear()
    build.load.cache_clear()
    words, n_pos = _packed([np.zeros(100, np.uint8)], 1, 2048, 21)
    before = hk.hash_packed_rows.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        hk._run(hk._rows_for(torch.device("cuda")),
                torch.from_numpy(words.view(np.int32)),
                torch.from_numpy(n_pos), 1, 2048, 21, 123, 1 << 60, True,
                "t1ha2", 128, 4)
    assert hk.hash_packed_rows.launches == before
    hk._entry.cache_clear()
    build.load.cache_clear()


def test_rejects_bad_geometry():
    words, n_pos = _packed([np.zeros(100, np.uint8)], 1, 2048, 21)
    w, n = torch.from_numpy(words.view(np.int32)), torch.from_numpy(n_pos)
    with pytest.raises(ValueError):
        hk.hash_packed_rows(w, n, 1, 2048, 21, 123, 1 << 60, cells=100)
    with pytest.raises(ValueError):
        hk.hash_packed_rows(w, n, 1, 2048, 21, 123, 1 << 60, cells=256)
    with pytest.raises(ValueError):
        hk.hash_packed_rows(w, n, 2, 2048, 21, 123, 1 << 60, cells=128)
    with pytest.raises(ValueError):
        hk.hash_packed_rows(w.to(torch.int64), n, 1, 2048, 21, 123, 1 << 60,
                            cells=128)
