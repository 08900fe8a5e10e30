"""K2, the chunk hash kernel: the port's plain version against the JAX Pallas
kernel (``hash_chunks_pallas``) in interpret mode, and the wrapper's routing.

The cases are those of tests/test_pallas_kernel.py. Tolerance: exact
equality of every hash (the U64_MAX sentinel where a window is not kept
included) and of every keep flag.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypergen_tpu.ops import u64 as ju
from hypergen_tpu.ops.pallas.hash_kernel import hash_chunks_pallas
from hypergen_tpu.params import fracminhash_threshold
from hypergen_tpu_torch.ops import u64 as tu
from hypergen_tpu_torch.ops.kernels import build
from hypergen_tpu_torch.ops.kernels import hash_kernel as hk


def _check(codes, k, seed, thr, method="t1ha2", canonical=True, cells=128):
    """Every output of hash_chunks against the Pallas kernel; returns the
    number of kept windows."""
    h_pal, keep_pal = hash_chunks_pallas(
        jnp.asarray(codes), k, seed, thr, canonical=canonical, method=method,
        interpret=True, cells=cells,
    )
    h, keep = hk.hash_chunks(
        torch.from_numpy(codes), k, seed, thr, canonical=canonical,
        method=method,
    )
    np.testing.assert_array_equal(keep.numpy(), np.asarray(keep_pal))
    np.testing.assert_array_equal(tu.to_numpy(h), ju.to_np_u64(h_pal))
    assert (tu.to_numpy(h)[~keep.numpy()] == np.uint64(2**64 - 1)).all()
    return int(keep.sum())


@pytest.mark.parametrize("k", [8, 15, 16, 21, 31, 32])
def test_plain_matches_pallas_k(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 5, size=(2, 1024 + k - 1)).astype(np.uint8)
    codes[1] = rng.integers(0, 4, size=1024 + k - 1)  # one junk-free row
    assert _check(codes, k, 7, fracminhash_threshold(2)) > 0


def test_plain_matches_pallas_mmhash():
    rng = np.random.default_rng(40)
    codes = rng.integers(0, 5, size=(2, 1044)).astype(np.uint8)
    assert _check(codes, 21, 123, fracminhash_threshold(2),
                  method="mmhash") > 0


def test_plain_matches_pallas_noncanonical():
    rng = np.random.default_rng(41)
    codes = rng.integers(0, 4, size=(1, 1044)).astype(np.uint8)
    assert _check(codes, 21, 123, fracminhash_threshold(1),
                  canonical=False) == 1024


def test_plain_matches_pallas_all_invalid():
    codes = np.full((1, 1044), 4, dtype=np.uint8)
    assert _check(codes, 21, 123, fracminhash_threshold(1)) == 0


def test_plain_matches_pallas_multi_lsub():
    """Several positions per Pallas cell: windows that cross cell
    boundaries through the halo, and codes above 4 as invalid."""
    rng = np.random.default_rng(42)
    codes = rng.integers(0, 5, size=(2, 4096 + 20)).astype(np.uint8)
    codes[0, 100:103] = 9
    assert _check(codes, 21, 123, fracminhash_threshold(2)) > 0


def test_plain_bounded_passes_match_one_pass(monkeypatch):
    """The plain version's pass size does not change its output."""
    rng = np.random.default_rng(43)
    codes = torch.from_numpy(
        rng.integers(0, 5, size=(5, 300 + 20)).astype(np.uint8))
    thr = fracminhash_threshold(3)
    whole = hk.hash_chunks_plain(codes, 21, 123, thr)
    monkeypatch.setattr(hk, "PLAIN_POSITIONS", 600)  # two chunks a pass
    for a, b in zip(hk.hash_chunks_plain(codes, 21, 123, thr), whole):
        assert torch.equal(a, b)


def test_cuda_route_never_falls_back(monkeypatch, tmp_path):
    """A CUDA tensor goes to K2 or raises: with no compiler and no built
    library the call fails, and the plain version is never run."""
    assert hk._chunks_for(torch.device("cuda", 0)) is hk._chunks_cuda
    assert hk._chunks_for(torch.device("cpu")) is hk._chunks_plain
    with pytest.raises(ValueError):
        hk._chunks_for(torch.device("meta"))

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    def plain_must_not_run(*a, **k):
        raise AssertionError("a CUDA call reached the plain version")

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_nvcc", no_nvcc)
    monkeypatch.setattr(hk, "_chunks_plain", plain_must_not_run)
    hk._entry.cache_clear()
    build.load.cache_clear()
    before = hk.hash_chunks.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        hk._run_chunks(hk._chunks_for(torch.device("cuda")),
                       torch.zeros((1, 100), dtype=torch.uint8), 21, 123,
                       1 << 60, True, "t1ha2")
    assert hk.hash_chunks.launches == before
    hk._entry.cache_clear()
    build.load.cache_clear()


@pytest.mark.parametrize("bad", ["dtype", "dim", "short", "method", "k"])
def test_rejects_bad_input(bad):
    codes = torch.zeros((2, 100), dtype=torch.uint8)
    args = dict(codes=codes, ksize=21, seed=123, threshold=1 << 60)
    if bad == "dtype":
        args["codes"] = codes.to(torch.int32)
    elif bad == "dim":
        args["codes"] = codes.reshape(-1)
    elif bad == "short":
        args["codes"] = codes[:, :20].contiguous()
    elif bad == "method":
        args["method"] = "md5"
    else:
        args["ksize"] = 33
    with pytest.raises(ValueError):
        hk.hash_chunks(**args)
