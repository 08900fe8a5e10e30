"""Tests of the PyTorch port that need a CUDA card; they skip without one.

This file imports no JAX (the machine with the card has none), so it runs
there without tests/conftest.py, which imports JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance: exact equality of bits, the CUDA kernel against its plain
PyTorch version and the card's sketches against the CPU's.
"""

import numpy as np
import pytest
import torch

from hypergen_tpu_torch.io.fastx import INVALID, packed_from_codes
from hypergen_tpu_torch.params import SketchParams, fracminhash_threshold
from hypergen_tpu_torch.models.sketcher import Sketcher, packed_row_words
from hypergen_tpu_torch.ops.kernels import hash_kernel as hk


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(cuda):
    """The CUDA kernel against the plain version, both on the card, with
    and without slot overflow."""
    rng = np.random.default_rng(1)
    nc, C, k = 4, 1 << 15, 21
    W = packed_row_words(nc, C)
    words = torch.from_numpy(
        rng.integers(0, 2**32, size=(2, W), dtype=np.uint64)
        .astype(np.uint32).view(np.int32)).to(cuda)
    n_pos = torch.tensor([nc * C - 1000, C + 7], dtype=torch.int32).to(cuda)
    args = (words, n_pos, nc, C, k, 123, fracminhash_threshold(50))
    for cap in (2, 11):
        before = hk.hash_packed_rows.launches
        a = hk.hash_packed_rows(*args, cells=2048, cap=cap)
        b = hk.hash_packed_rows_plain(*args, cells=2048, cap=cap)
        assert hk.hash_packed_rows.launches == before + 1
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert int(a[3].max()) > 2  # cap=2 overflowed, cap=11 did not
    assert int(a[3].max()) <= 11


@pytest.mark.cuda
def test_cuda_sketch_matches_cpu(cuda):
    """The whole sketch step on the card equals the CPU run, including a
    batch that climbs the cell-cap ladder."""
    rng = np.random.default_rng(4)
    genomes = []
    for L in (9000, 3000, 40):
        codes = rng.integers(0, 4, size=L).astype(np.uint8)
        codes[L // 3 : L // 3 + 25] = INVALID
        genomes.append(packed_from_codes(codes))
    rep = np.tile(np.array([0, 0, 1, 1], np.uint8), 600)  # (AACC)n
    codes = rng.integers(0, 4, size=8000).astype(np.uint8)
    codes[2000 : 2000 + rep.size] = rep
    genomes.append(packed_from_codes(codes))
    p = SketchParams(scaled=50, hv_d=1024)
    before = hk.hash_packed_rows.launches
    got = Sketcher(p, device=cuda, chunk_positions=4096).sketch_batch(genomes)
    assert hk.hash_packed_rows.launches >= before + 2  # the ladder climbed
    want = Sketcher(p, device="cpu", chunk_positions=4096).sketch_batch(genomes)
    for a, b in zip(got, want):
        assert a["n_hashes"] == b["n_hashes"] and a["norm2"] == b["norm2"]
        np.testing.assert_array_equal(a["hv"], b["hv"])


@pytest.mark.cuda
def test_cuda_chunk_kernel_matches_plain(cuda):
    """K2 against its plain version on the card, every hash (sentinel
    included) and keep flag, with a chunk width that leaves a short last
    cell and an all-invalid chunk."""
    rng = np.random.default_rng(6)
    for k, method, canonical, scaled in ((21, "t1ha2", True, 2),
                                         (32, "t1ha2", True, 3),
                                         (15, "mmhash", True, 2),
                                         (8, "t1ha2", False, 1)):
        codes = rng.integers(0, 4, size=(3, 1000 + k - 1)).astype(np.uint8)
        codes[rng.random(codes.shape) < 0.02] = INVALID
        codes[2] = INVALID
        codes = torch.from_numpy(codes).to(cuda)
        args = (codes, k, 123, fracminhash_threshold(scaled))
        kw = dict(canonical=canonical, method=method)
        before = hk.hash_chunks.launches
        a = hk.hash_chunks(*args, **kw)
        b = hk.hash_chunks_plain(*args, **kw)
        assert hk.hash_chunks.launches == before + 1
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        assert a[1].any() and not a[1][2].any()


@pytest.mark.cuda
def test_cuda_huge_genome_routes_match_cpu(cuda):
    """seqpar over [card] * 3 and the tiled route on the card equal their
    CPU runs and the one-shot step."""
    from hypergen_tpu_torch.parallel.seqpar import sketch_codes_seqpar

    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, size=30_000).astype(np.uint8)
    codes[4090:4110] = INVALID
    g = packed_from_codes(codes)
    p = SketchParams(scaled=20, hv_d=1024)
    want = Sketcher(p, device="cpu", chunk_positions=2048).sketch_batch([g])[0]
    got = [
        sketch_codes_seqpar(codes, p, [cuda] * 3, chunk_positions=1024),
        sketch_codes_seqpar(codes, p, ["cpu"] * 3, chunk_positions=1024),
        Sketcher(p, device=cuda, chunk_positions=2048).sketch_packed_tiled(g, 2),
    ]
    for a in got:
        assert a["n_hashes"] == want["n_hashes"] and a["norm2"] == want["norm2"]
        np.testing.assert_array_equal(a["hv"], want["hv"])


def _k1_case(cuda, rng, nc, C, cells, k, n_pos, cap=4, scaled=8):
    """K1 on random packed rows against its plain version, every output."""
    W = packed_row_words(nc, C)
    words = torch.from_numpy(
        rng.integers(0, 2**32, size=(len(n_pos), W), dtype=np.uint64)
        .astype(np.uint32).view(np.int32)).to(cuda)
    n_pos = torch.tensor(n_pos, dtype=torch.int32).to(cuda)
    args = (words, n_pos, nc, C, k, 123, fracminhash_threshold(scaled))
    before = hk.hash_packed_rows.launches
    a = hk.hash_packed_rows(*args, cells=cells, cap=cap)
    b = hk.hash_packed_rows_plain(*args, cells=cells, cap=cap)
    assert hk.hash_packed_rows.launches == before + 1
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    return a


@pytest.mark.cuda
@pytest.mark.parametrize("C,lsub", [(2048, 16), (4096, 32)])
def test_cuda_k1_small_lsub(cuda, C, lsub):
    """K1 where a cell holds 16 or 32 positions (small chunks: one u32 of
    codes per load instead of a uint4), k short and long."""
    rng = np.random.default_rng(lsub)
    for k in (9, 21, 32):
        a = _k1_case(cuda, rng, 3, C, C // lsub, k, [3 * C - 5, C + 3])
        assert a[2].any()


@pytest.mark.cuda
def test_cuda_k1_rows_end_mid_block_and_cell(cuda):
    """Rows whose n_pos ends inside a cell and inside a block of 128 cells:
    the cell stops emitting there, later cells write only sentinels."""
    rng = np.random.default_rng(11)
    C, cells = 1 << 15, 512  # lsub 64, 4 blocks of 128 cells a chunk
    ends = [C + 64 * 37 + 13, 2 * C + 64 * 200 + 1, 64 * 129 - 1, 64 * 5]
    a = _k1_case(cuda, rng, 3, C, cells, 21, ends, cap=8, scaled=4)
    pos, valid = a[1], a[2]
    for row, end in enumerate(ends):
        assert int(pos[row][valid[row]].max()) < end


@pytest.mark.cuda
@pytest.mark.parametrize("C", [700, 2049, 5000])
def test_cuda_k2_ragged_chunks(cuda, C):
    """K2 with chunks shorter than one 2048-position strip and not a
    multiple of it, and rows that start off 16-byte alignment (odd C + k -
    1), which take the narrower stores."""
    rng = np.random.default_rng(C)
    k = 21
    codes = rng.integers(0, 4, size=(3, C + k - 1)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.01] = INVALID
    codes = torch.from_numpy(codes).to(cuda)
    args = (codes, k, 123, fracminhash_threshold(2))
    a = hk.hash_chunks(*args)
    b = hk.hash_chunks_plain(*args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert a[1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8, 31, 32])
def test_cuda_k2_k_and_edges(cuda, k):
    """K2 at k 1, 8, 31 and 32, with invalid codes on the edges of the
    2048-position strips, of the 64 positions a lane rolls, and in the k-1
    halo of each chunk."""
    rng = np.random.default_rng(100 + k)
    C = 4500
    codes = rng.integers(0, 4, size=(3, C + k - 1)).astype(np.uint8)
    for e in (63, 64, 65, 2047, 2048, 4095, 4096, C, C + k - 2):
        if e < codes.shape[1]:
            codes[:, e] = INVALID
    codes[1, C:] = 9  # the whole halo of one chunk
    codes = torch.from_numpy(codes).to(cuda)
    for method, canonical in (("t1ha2", True), ("mmhash", True),
                              ("t1ha2", False)):
        args = (codes, k, 123, fracminhash_threshold(2))
        kw = dict(canonical=canonical, method=method)
        a = hk.hash_chunks(*args, **kw)
        b = hk.hash_chunks_plain(*args, **kw)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        assert a[1].any()
