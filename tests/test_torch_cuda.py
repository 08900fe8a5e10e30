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


def _hv_rows(seed, m, d, dups=True):
    """int16 HVs bundling +-1 vectors of overlapping windows of one pool
    (ANIs from 0 to ~99), rows 4 and m - 1 exact copies of row 1, and
    their wrapping int32 norm^2."""
    vecs = np.random.default_rng(0).choice(
        np.array([-1, 1], np.int64), size=(4 * m, d))
    rng = np.random.default_rng(seed)
    hv = np.zeros((m, d), np.int64)
    for i in range(m):
        lo = int(rng.integers(0, 3 * m))
        hv[i] = vecs[lo : lo + m][rng.random(m) < 0.9].sum(0)
    hv = hv.astype(np.int16)
    if dups:
        hv[4] = hv[m - 1] = hv[1]
    return hv, (hv.astype(np.int64) ** 2).sum(-1).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 16, 17, 40])
def test_cuda_int8_dot_matches_float64(cuda, m):
    """The int8 dots (4-way, 3-product, and their resident forms) on the
    card equal the float64 dot wrapped to int32, at -32768, 32767 and
    +-6175/6176 (the int32 accumulation wraps), for m at and below the 16
    rows cuBLASLt's int8 product refuses and D, N not multiples of 8."""
    from hypergen_tpu_torch.ops import ani

    rng = np.random.default_rng(m)
    for d, n in ((4096, 8), (37, 3), (520, 9)):
        for mode, lo, hi in (("small", -6175, 6175), (True, -32768, 32767)):
            r = rng.integers(lo, hi + 1, size=(m, d)).astype(np.int16)
            q = rng.integers(lo, hi + 1, size=(n, d)).astype(np.int16)
            r[0], q[0] = hi, hi
            q[n - 1] = lo
            if hi > 6175:
                q[1 % n, ::2] = 6176
                r[m - 1, 1::2] = -6176
            rt, qt = torch.from_numpy(r).to(cuda), torch.from_numpy(q).to(cuda)
            want = ani.dot_i16_exact(rt, qt, False)
            exact = (r.astype(np.int64) @ q.astype(np.int64).T)
            np.testing.assert_array_equal(want.cpu().numpy(),
                                          exact.astype(np.int32))
            split = (ani.presplit_rows_small(rt) if mode == "small"
                     else ani.presplit_rows(rt))
            for got in (ani.dot_i16_exact(rt, qt, mode),
                        ani.dot_i16_any(split, qt, mode),
                        ani.dot_i16_exact(rt, qt, None)):
                assert got.dtype == torch.int32 and got.device == rt.device
                assert torch.equal(got, want)
    assert d == 520 and abs(int(exact[0, 0])) > 2**31


@pytest.mark.cuda
def test_cuda_search_and_dist_cli_match_cpu(cuda, tmp_path):
    """`search` and `dist` through the CLI on the card give the -D cpu
    bytes, on a .hgdb with duplicated rows (ties at the k-th place) and 37
    queries, some of them DB rows."""
    from hypergen_tpu_torch.cli import main
    from hypergen_tpu_torch.io.sketch_db import ShardedDB, dump_sharded_db

    hv, norm = _hv_rows(1, 300, 512)
    qhv, qnorm = _hv_rows(2, 37, 512, dups=False)
    qhv[:3], qnorm[:3] = hv[[1, 2, 250]], norm[[1, 2, 250]]

    def db(names, h, n):
        return ShardedDB(ksize=21, scaled=1500, canonical=True, seed=123,
                         hv_d=512, names=names, hvs=h, norms=n)

    dump_sharded_db(db([f"r{i}" for i in range(300)], hv, norm),
                    tmp_path / "r.hgdb", n_shards=3)
    dump_sharded_db(db([f"q{i}" for i in range(37)], qhv, qnorm),
                    tmp_path / "q.hgdb")
    r, q = str(tmp_path / "r.hgdb"), str(tmp_path / "q.hgdb")
    runs = [("search", ["--top_k", "5", "-a", "0"]),
            ("dist", ["-a", "85"]), ("dist", ["-a", "0"])]
    for i, (cmd, extra) in enumerate(runs):
        for dev in ("cuda", "cpu"):
            main([cmd, "-r", r, "-q", q, "-o", str(tmp_path / f"{i}{dev}"),
                  *extra, "-D", dev])
        want = (tmp_path / f"{i}cpu").read_bytes()
        assert want and (tmp_path / f"{i}cuda").read_bytes() == want
    # the three copies tie at 100: ranked lowest row first, printed with
    # ties reversed (reference:src/utils.rs:262-269)
    top = [line.split("\t") for line in
           (tmp_path / "0cpu").read_text().splitlines()[:3]]
    assert top == [[r, "q0", "100.000"] for r in ("r299", "r4", "r1")]


@pytest.mark.cuda
def test_cuda_sharded_search_matches_tiled(cuda):
    """sharded_topk_search over [card] x 3 equals the running top-k over
    row tiles on the card; the sharded search on the CPU picks the same
    winners (its float32 ANIs may differ from the card's in the last bit:
    within 1e-4)."""
    from hypergen_tpu_torch.parallel.search import (
        local_topk_search_tiled, sharded_topk_search,
    )

    hv, norm = _hv_rows(3, 200, 256)
    qhv, qnorm = _hv_rows(4, 24, 256, dups=False)
    qhv[0], qnorm[0] = hv[1], norm[1]
    args = (hv, norm, qhv, qnorm, 21, 7)
    a = sharded_topk_search([cuda] * 3, *args)
    b = local_topk_search_tiled(*args, tile_m=64, device=cuda)
    c = sharded_topk_search(["cpu"] * 3, *args, mode=True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    for x, z in zip(a[1:], c[1:]):
        np.testing.assert_array_equal(x, z)
    np.testing.assert_allclose(a[0], c[0], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(a[1][0, :3], [1, 4, 199])


_POD_SEARCH = """
import sys
import numpy as np
from hypergen_tpu_torch.parallel import mesh
from hypergen_tpu_torch.parallel.search import multihost_topk_search
from hypergen_tpu_torch.utils.logging import setup_logging
setup_logging()
mesh.maybe_init_distributed("cuda")
try:
    q = np.load(sys.argv[2])
    res = multihost_topk_search(sys.argv[1], q["hv"], q["norm"], 21, 7,
                                mesh.local_devices("cuda"))
    np.savez(sys.argv[3] % mesh.process_index(), ani=res[0], idx=res[1],
             dot=res[2])
finally:
    mesh.finalize()
"""


@pytest.mark.cuda
def test_cuda_pod_search_matches_sharded(cuda, tmp_path):
    """Two processes, each on its own card over NCCL (one card: both on
    cuda:0 over gloo), run multihost_topk_search; the arrays equal the
    one-process sharded_topk_search over the same cards."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    from hypergen_tpu_torch.io.sketch_db import ShardedDB, dump_sharded_db
    from hypergen_tpu_torch.parallel.search import sharded_topk_search

    hv, norm = _hv_rows(5, 301, 256)
    qhv, qnorm = _hv_rows(6, 24, 256, dups=False)
    qhv[0], qnorm[0] = hv[1], norm[1]
    dump_sharded_db(ShardedDB(ksize=21, scaled=1500, canonical=True,
                              seed=123, hv_d=256,
                              names=[f"r{i}" for i in range(301)], hvs=hv,
                              norms=norm), tmp_path / "r.hgdb", n_shards=3)
    np.savez(tmp_path / "q.npz", hv=qhv, norm=qnorm)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = Path(__file__).resolve().parent.parent
    procs = []
    for pid in range(2):
        env = dict(os.environ, HG_NUM_PROCESSES="2", HG_PROCESS_ID=str(pid),
                   HG_COORDINATOR=f"localhost:{port}",
                   HG_DIST_TIMEOUT_S="120",
                   PYTHONPATH=str(root) + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        env.pop("LOCAL_RANK", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _POD_SEARCH, str(tmp_path / "r.hgdb"),
             str(tmp_path / "q.npz"), str(tmp_path / "out%d.npz")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= 2 else "gloo"
    assert all(f"backend {backend}" in out for out in outs)
    devs = [torch.device("cuda", i % cards) for i in range(2)]
    want = sharded_topk_search(devs, hv, norm, qhv, qnorm, 21, 7)
    for r in range(2):
        got = np.load(tmp_path / f"out{r}.npz")
        for name, w in zip(("ani", "idx", "dot"), want):
            np.testing.assert_array_equal(got[name], w)
    np.testing.assert_array_equal(want[1][0, :3], [1, 4, 300])


def _write_genomes(d, lengths, seed):
    rng = np.random.default_rng(seed)
    d.mkdir()
    paths = []
    for i, bp in enumerate(lengths):
        seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=bp)]
        seq[bp // 3 : bp // 3 + 40 + i] = ord("N")
        paths.append(d / f"g{i}.fna")
        paths[-1].write_bytes(b">g\n" + seq.tobytes() + b"\n")
    return paths


@pytest.mark.cuda
def test_cuda_stage_timing_logs_device_stages(cuda, tmp_path, monkeypatch):
    """HG_STAGE_TIMING on the card: the table names the device stages, each
    timed above 0 by CUDA events (read from last_device_times: the table
    rounds to ms), and the .sketch bytes do not change."""
    import logging

    from hypergen_tpu_torch.cli import main

    totals = []
    orig = Sketcher.sketch_files

    def spy(self, *a, **kw):
        out = orig(self, *a, **kw)
        totals.append(dict(self.last_device_times))
        return out

    monkeypatch.setattr(Sketcher, "sketch_files", spy)

    d = tmp_path / "g"
    _write_genomes(d, [200_000, 150_000, 180_000], seed=71)
    argv = ["sketch", "-p", str(d), "-D", "cuda"]
    monkeypatch.delenv("HG_STAGE_TIMING", raising=False)
    main(argv + ["-o", str(tmp_path / "off.sketch")])
    monkeypatch.setenv("HG_STAGE_TIMING", "1")
    seen = []

    class Keep(logging.Handler):
        def emit(self, record):
            seen.append(record.getMessage())

    logger, handler = logging.getLogger("hypergen"), Keep()
    logger.addHandler(handler)
    try:
        main(argv + ["-o", str(tmp_path / "on.sketch")])
    finally:
        logger.removeHandler(handler)
    (msg,) = [m for m in seen if m.startswith("sketch stage timing:")]
    logged = {ln.split(": ")[0] for ln in msg.splitlines()[1:]}
    for stage in ("hash", "compact", "distinct", "encode"):
        assert stage in logged and totals[-1][stage] > 0, (stage, msg)
    assert ((tmp_path / "on.sketch").read_bytes()
            == (tmp_path / "off.sketch").read_bytes())


@pytest.mark.cuda
def test_cuda_sketch_file_and_codes_match_cpu(cuda, tmp_path):
    """sketch_file and sketch_codes on the card equal the same calls on the
    CPU, for a batch genome and one that takes the huge-genome route."""
    from hypergen_tpu_torch.io.fastx import codes_from_packed, read_genome_packed

    p = SketchParams(scaled=40, hv_d=1024)
    paths = _write_genomes(tmp_path / "g", [12_000, 60_000], seed=72)
    for path in paths:
        codes = codes_from_packed(read_genome_packed(path))
        got, want = (Sketcher(p, device=dev, chunk_positions=2048,
                              seqpar_min_chunks=16) for dev in (cuda, "cpu"))
        a, b = got.sketch_file(path), want.sketch_file(path)
        assert a.hv_norm_2 == b.hv_norm_2 and a.file_str == b.file_str
        np.testing.assert_array_equal(a.decompress(), b.decompress())
        a, b = got.sketch_codes(codes), want.sketch_codes(codes)
        assert a["n_hashes"] == b["n_hashes"] > 0 and a["norm2"] == b["norm2"]
        np.testing.assert_array_equal(a["hv"], b["hv"])


def _pipeline_groups(rng, n_groups, per_group=2):
    """Groups of random genomes with N runs, two buckets."""
    groups = []
    for i in range(n_groups):
        g = []
        for j in range(per_group):
            codes = rng.integers(0, 4, size=9000 + 5000 * (i % 2) + 300 * j)
            codes = codes.astype(np.uint8)
            codes[1000 + j : 1030 + j] = INVALID
            g.append(packed_from_codes(codes))
        groups.append(g)
    return groups


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x["n_hashes"] == y["n_hashes"] and x["norm2"] == y["norm2"]
        np.testing.assert_array_equal(x["hv"], y["hv"])


@pytest.mark.cuda
def test_cuda_submit_reads_nothing_back(cuda):
    """No submit reads the card on the host: under set_sync_debug_mode
    ("error") such a read raises (checked live with .item())."""
    p = SketchParams(scaled=40, hv_d=1024)
    sk = Sketcher(p, device=cuda, chunk_positions=4096, batch=2)
    groups = _pipeline_groups(np.random.default_rng(80), 4)
    want = [sk.sketch_batch(g) for g in groups]  # builds and warms up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):
            torch.zeros(1, device=cuda).item()
        handles = [sk.submit_batch_packed(g) for g in groups]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for h, w in zip(handles, want):
        _same(sk.collect_batch(h), w)


@pytest.mark.cuda
def test_cuda_collect_in_reverse_equals_sketch_batch(cuda):
    p = SketchParams(scaled=40, hv_d=1024)
    sk = Sketcher(p, device=cuda, chunk_positions=4096, batch=2)
    groups = _pipeline_groups(np.random.default_rng(81), 5)
    handles = [sk.submit_batch_packed(g) for g in groups]
    got = sk.collect_batches(handles[::-1])[::-1]
    for g, res in zip(groups, got):
        _same(res, sk.sketch_batch(g))
    cpu = Sketcher(p, device="cpu", chunk_positions=4096, batch=2)
    _same(got[0], cpu.sketch_batch(groups[0]))


@pytest.mark.cuda
def test_cuda_sketch_files_depth_3_equals_depth_1(cuda, tmp_path):
    from hypergen_tpu_torch.io.sketch_db import dump_sketch

    paths = _write_genomes(tmp_path / "g", [60_000, 9_000, 70_000, 8_000,
                                            65_000, 12_000, 7_000], seed=82)
    p = SketchParams(scaled=40, hv_d=1024)
    sk = Sketcher(p, device=cuda, chunk_positions=4096, batch=2)
    out = []
    for depth in (1, 3):
        dump_sketch(sk.sketch_files(paths, progress=False,
                                    pipeline_depth=depth),
                    tmp_path / f"d{depth}.sketch")
        out.append((tmp_path / f"d{depth}.sketch").read_bytes())
        assert sum(sk.last_device_times.values()) > 0
        assert "collect" in sk.last_stage_times
    assert out[0] == out[1]


@pytest.mark.cuda
def test_cuda_pinned_buffers_not_overwritten_in_flight(cuda):
    """pipeline_depth + 2 batches submitted before the first collect: each
    pack writes a fresh pinned buffer while the earlier uploads may still
    be in flight, and every result equals its batch sketched alone."""
    depth = 3
    p = SketchParams(scaled=40, hv_d=1024)
    sk = Sketcher(p, device=cuda, chunk_positions=4096, batch=2)
    groups = _pipeline_groups(np.random.default_rng(83), depth + 2)
    handles = [sk.submit_batch_packed(g) for g in groups]
    assert all(h.host.buf.is_pinned() for h in handles)
    got = sk.collect_batches(handles)
    for g, res in zip(groups, got):
        _same(res, sk.sketch_batch(g))


# -- the encode kernel (csrc/encode_kernel.cu) ---------------------------------


def _encode_rows(rng, B, N, frac=0.45):
    """Step-like encode inputs: each row's sorted hashes with a
    first-occurrence mask over about `frac` of the width, the rest padding
    (-1, invalid), as distinct_hashes gives them."""
    h = rng.integers(0, 2**63, size=(B, N), dtype=np.uint64).view(np.int64)
    h = np.sort(h, axis=-1)
    valid = rng.random((B, N)) < frac
    return torch.from_numpy(np.where(valid, h, -1)), torch.from_numpy(valid)


def _encode_same(cuda, h, valid, hv_d):
    from hypergen_tpu_torch.ops.kernels import encode_kernel as ek

    h, valid = h.to(cuda), valid.to(cuda)
    before = ek.encode_hv_i16.launches
    got = ek.encode_hv_i16(h, valid, hv_d)
    want = ek.encode_hv_i16_plain(h, valid, hv_d)
    assert ek.encode_hv_i16.launches == before + (h.shape[0] > 0)
    for x, y in zip(got, want):
        assert x.device == y.device and torch.equal(x, y)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,hv_d", [(8, 6144, 4096), (3, 1001, 256),
                                      (1, 179_712, 4096), (2, 130, 8192),
                                      (5, 0, 512), (0, 130, 256)])
def test_cuda_encode_kernel_matches_plain(cuda, B, N, hv_d):
    """The kernel against its plain version, bit for bit, at the 16-genome
    step's 8 x 6,144 at D = 4096, a ragged D = 256, the 2^27 bp one-row
    width, a D above one block of words, no hashes at all, and no rows
    (nothing launched, nothing counted)."""
    rng = np.random.default_rng(B * N + hv_d)
    _encode_same(cuda, *_encode_rows(rng, B, N), hv_d)


@pytest.mark.cuda
@pytest.mark.parametrize("hv_d", [256, 4096])
def test_cuda_encode_kernel_wraps(cuda, hv_d):
    """One hash 40,000 times (the int16 wrap and the int32 norm^2 wrap),
    a row with no valid entry, and 300,000 all-valid hashes in one row
    (several tiles a slab and the planes' flushes)."""
    rng = np.random.default_rng(hv_d)
    h, valid = _encode_rows(rng, 3, 300_000, frac=1.0)
    h[0, :40_000] = h[0, 0]
    valid[0, 40_000:] = False
    valid[1] = False
    hv16, norm2 = _encode_same(cuda, h, valid, hv_d)
    assert int(norm2[1]) == 0 and not hv16[1].any()
    assert set(hv16[0].abs().tolist()) == {65_536 - 40_000}


@pytest.mark.cuda
def test_cuda_encode_kernel_on_every_route(cuda):
    """The step launches the encode once a submit under
    set_sync_debug_mode("error"), the tiled route once a genome, seqpar
    once a slab; all equal the CPU."""
    from hypergen_tpu_torch.ops.kernels import encode_kernel as ek
    from hypergen_tpu_torch.parallel.seqpar import sketch_codes_seqpar

    p = SketchParams(scaled=40, hv_d=1024)
    sk = Sketcher(p, device=cuda, chunk_positions=4096, batch=2)
    groups = _pipeline_groups(np.random.default_rng(84), 3)
    want = [sk.sketch_batch(g) for g in groups]  # builds and warms up
    torch.cuda.synchronize()
    before = ek.encode_hv_i16.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        handles = [sk.submit_batch_packed(g) for g in groups]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ek.encode_hv_i16.launches == before + len(groups)
    for h, w in zip(handles, want):
        _same(sk.collect_batch(h), w)
    codes = np.random.default_rng(85).integers(0, 4, size=60_000)
    codes = codes.astype(np.uint8)
    cpu = Sketcher(p, device="cpu", chunk_positions=4096, batch=2)
    ref = cpu.sketch_codes(codes)
    for route, n in (("tiled", 1), ("seqpar", 3)):
        before = ek.encode_hv_i16.launches
        if route == "tiled":
            got = sk.sketch_packed_tiled(packed_from_codes(codes),
                                         tile_chunks=4)
        else:
            got = sketch_codes_seqpar(codes, p, [cuda] * 3,
                                      chunk_positions=4096)
        assert ek.encode_hv_i16.launches == before + n, route
        _same([got], [ref])
