"""The PyTorch port's top-k search against the JAX package's on the CPU.

The port's searches over ["cpu"] * n against the JAX package's over a mesh
of n virtual CPU devices (tests/conftest.py makes 8). Tolerance: equal
winner indices and exact int32 dots, the -inf slots of short shards and
masked padding included; the device float32 ANI within 1e-4 ANI%%, because
XLA's float chain (its own log) and PyTorch's differ in the last bits;
equal TSV bytes.
"""

import jax
import numpy as np
import pytest
import torch

from hypergen_tpu.models import comparator as jax_comp
from hypergen_tpu.parallel import search as jax_search
from hypergen_tpu.parallel.mesh import make_mesh
from hypergen_tpu_torch.models import comparator as torch_comp
from hypergen_tpu_torch.parallel import search as torch_search


def _db(seed, m, d=96, pool=400, span=120):
    """HVs bundling +-1 vectors of overlapping windows of one pool (ANIs
    from 0 to ~99), with exact copies of rows 1 and 2 (equal ANIs at the
    k-th place) and the int32 norm^2 of each row."""
    vecs = np.random.default_rng(0).choice(
        np.array([-1, 1], np.int64), size=(pool, d))
    rng = np.random.default_rng(seed)
    hv = np.zeros((m, d), np.int64)
    for i in range(m):
        lo = int(rng.integers(0, pool - span))
        hv[i] = vecs[lo : lo + span][rng.random(span) < 0.9].sum(0)
    hv = hv.astype(np.int16)
    if m > 6:
        hv[4] = hv[m - 1] = hv[1]
        hv[6] = hv[2]
    return hv, (hv.astype(np.int64) ** 2).sum(-1).astype(np.int32)


@pytest.fixture(scope="module")
def data():
    db_hv, db_norm = _db(1, 10)
    q_hv, q_norm = _db(2, 5)
    q_hv[0] = db_hv[1]  # three exact copies in the DB: 100 at 1, 4, 9
    q_hv[1] = db_hv[6]
    q_norm = (q_hv.astype(np.int64) ** 2).sum(-1).astype(np.int32)
    return db_hv, db_norm, q_hv, q_norm


def _assert_same(got, want):
    ani, idx, dot = got
    jani, jidx, jdot = (np.asarray(x) for x in want)
    assert ani.dtype == np.float32 and idx.dtype == dot.dtype == np.int32
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(dot, jdot)
    np.testing.assert_array_equal(np.isinf(ani), np.isinf(jani))
    np.testing.assert_allclose(ani, jani, rtol=0, atol=1e-4)


def _mesh(n):
    return make_mesh(n, 1, devices=jax.devices()[:n])


MODES = [None, True, "small"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("k", [1, 3, 5, 12])
def test_sharded_topk_matches_jax(data, n, k, mode):
    """One sharded pass over n shards; k up to past the shard size (5 > 3
    rows a shard at n=4) and past M (12 > 10)."""
    got = torch_search.topk_search(["cpu"] * n, *data, 21, k, mode)
    want = jax_search.sharded_topk_search(_mesh(n), *data, 21, k,
                                          use_mxu=mode)
    _assert_same(got, want)
    if k >= 3:  # the three copies of the query tie at 100: lowest first
        np.testing.assert_array_equal(got[1][0, :3], [1, 4, 9])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tile_m,k", [(4, 3), (3, 5), (8, 12), (16, 2)])
def test_local_tiled_topk_matches_jax(data, tile_m, k, mode):
    """Row tiles on one device against the JAX package's running top-k
    over tiles; ties across tiles keep the earlier tile's row."""
    got = torch_search.topk_search(["cpu"], *data, 21, k, mode=mode,
                                   tile_rows=tile_m)
    want = jax_search.local_topk_search_tiled(
        *data, 21, k, tile_m=tile_m, use_mxu=mode)
    _assert_same(got, want)


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("tile_m,k", [(4, 3), (6, 5), (8, 12)])
def test_sharded_tiled_topk_matches_jax(data, n, tile_m, k):
    got = torch_search.topk_search(["cpu"] * n, *data, 21, k,
                                   tile_rows=tile_m)
    want = jax_search.sharded_topk_search_tiled(
        _mesh(n), *data, 21, k, tile_m=tile_m)
    _assert_same(got, want)


@pytest.mark.parametrize("n", [1, 3])
def test_routes_give_one_answer(data, n, monkeypatch):
    """Row tiles (4 of them) give the winners of one pass, on one device
    and on several; the last tile stops at the padded end."""
    one = torch_search.topk_search(["cpu"] * n, *data, 21, 4)
    tiles = []  # (lo, rows) of each row tile
    orig = torch_search._block_candidates
    monkeypatch.setattr(torch_search, "_block_candidates",
                        lambda *a: tiles.append(a[3:5]) or orig(*a))
    tiled = torch_search.topk_search(["cpu"] * n, *data, 21, 4, tile_rows=3)
    assert len(tiles) == 4
    assert sum(rows for _, rows in tiles) == -(-10 // n) * n
    for a, b in zip(one, tiled):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tile_rows", [1, 2, 3, 5, None])
@pytest.mark.parametrize("n", [1, 2, 3, 8])
@pytest.mark.parametrize("k", [1, 3, 10, 12])
def test_tiles_devices_and_k_match_jax(data, tile_rows, n, k):
    """Every tiling over every device count, k up to M and past it,
    against the JAX package's one sharded pass."""
    got = torch_search.topk_search(["cpu"] * n, *data, 21, k,
                                   tile_rows=tile_rows)
    want = jax_search.sharded_topk_search(_mesh(n), *data, 21, k)
    _assert_same(got, want)


def test_search_reports_match_jax(tmp_path):
    """write_search_report, count_search_hits and format_ani_report with
    NaN slots, ties and a threshold cut, against the JAX package's."""
    rng = np.random.default_rng(3)
    ani = rng.choice(np.array([99.5, 97.25, 85.0, 80.0, np.nan], np.float32),
                     size=(7, 4))
    idx = rng.integers(0, 6, size=(7, 4)).astype(np.int32)
    rn, qn = [f"r{i}" for i in range(6)], [f"q{i}" for i in range(7)]
    for thr in (0.0, 85.0, 99.9):
        a = torch_comp.write_search_report(tmp_path / "t", rn, qn, idx, ani,
                                           thr, chunk_queries=3)
        b = jax_comp.write_search_report(tmp_path / "j", rn, qn, idx, ani,
                                         thr)
        assert a == b == torch_comp.count_search_hits(ani, thr)
        assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
        flat = dict(ref_idx=idx.ravel(), query_idx=np.repeat(np.arange(7), 4),
                    ani=ani.ravel(), threshold=thr, top_k=5)
        assert (torch_comp.format_ani_report(rn, qn, **flat)
                == jax_comp.format_ani_report(rn, qn, **flat))


def test_write_search_tsv_is_the_host_chain(data, tmp_path):
    """The TSV's ANIs come from the host chain on the winners' exact dots;
    -inf slots (k past M) write nothing."""
    from hypergen_tpu_torch.io.sketch_db import ShardedDB

    db_hv, db_norm, q_hv, q_norm = data
    ani, idx, dot = torch_search.topk_search(["cpu"] * 4, *data, 21, 12)
    q = ShardedDB(ksize=21, scaled=1500, canonical=True, seed=123, hv_d=96,
                  names=[f"q{i}" for i in range(5)], hvs=q_hv, norms=q_norm)
    n = torch_search.write_search_tsv(
        tmp_path / "hits.tsv", [f"r{i}" for i in range(10)], db_norm, q,
        ani, idx, dot, 0.0)
    rows = (tmp_path / "hits.tsv").read_text().splitlines()
    assert n == len(rows) == 5 * 10
    host = torch_comp.ani_f32_host(
        (db_hv.astype(np.int64) @ q_hv.astype(np.int64).T).astype(np.int32),
        db_norm, q_norm, 21)
    for line in rows:
        r, qq, v = line.split("\t")
        assert v == f"{host[int(r[1:]), int(qq[1:])]:.3f}"


def _straddling(data, q_over):
    """data with DB rows 4 (6176) and 7 (-32768) past SMALL_SPLIT_MAX, in
    the second and third of tile_rows=3's row tiles, the other tiles
    fitting; with q_over also query 2 past it (6176)."""
    db_hv, db_norm, q_hv, q_norm = (a.copy() for a in data)
    db_hv[4, 5], db_hv[7, 0] = 6176, -32768
    if q_over:
        q_hv[2, 9] = 6176
    return tuple(x for h in (db_hv, q_hv)
                 for x in (h, (h.astype(np.int64) ** 2).sum(-1)
                           .astype(np.int32)))


# (devices, the tiles' parts that fit, those that do not): at tile_rows=3
# one device has the parts 0-2, 3-5 (6176), 6-8 (-32768), 9; two have
# 0-1, 2-3; 4-5, 6-7; 8, 9
@pytest.mark.parametrize("n,small,split4", [(1, 2, 2), (2, 4, 2)])
@pytest.mark.parametrize("q_over", [False, True])
def test_straddling_tiles_take_their_own_modes(data, tmp_path, n, small,
                                               split4, q_over):
    """mode=True decides each tile's mode from its own rows (and the
    queries): the 3-product split where the tile and the queries fit, the
    4-way one elsewhere, every tile 4-way when a query is past the bound.
    The top-k and the TSV equal mode=False's and the JAX package's."""
    from hypergen_tpu.cli import main as jax_main
    from hypergen_tpu_torch.io.sketch_db import ShardedDB, dump_sharded_db
    from hypergen_tpu_torch.utils.timing import COUNTERS

    mixed = _straddling(data, q_over)
    devs = ["cpu"] * n
    before = (COUNTERS.dot_tiles_small, COUNTERS.dot_tiles_split4)
    got = torch_search.topk_search(devs, *mixed, 21, 5, mode=True,
                                   tile_rows=3)
    counted = (COUNTERS.dot_tiles_small - before[0],
               COUNTERS.dot_tiles_split4 - before[1])
    assert counted == ((0, small + split4) if q_over else (small, split4))
    direct = torch_search.topk_search(devs, *mixed, 21, 5, mode=False,
                                      tile_rows=3)
    for a, b in zip(got, direct):
        np.testing.assert_array_equal(a, b)
    _assert_same(got, jax_search.sharded_topk_search_tiled(
        _mesh(n), *mixed, 21, 5, tile_m=3, use_mxu=True))

    def db(prefix, hv, norm):
        return ShardedDB(ksize=21, scaled=1500, canonical=True, seed=123,
                         hv_d=96, names=[f"{prefix}{i}" for i in
                                         range(hv.shape[0])],
                         hvs=hv, norms=norm)

    ref, q = db("r", *mixed[:2]), db("q", *mixed[2:])
    dump_sharded_db(ref, tmp_path / "r.hgdb", n_shards=2)
    dump_sharded_db(q, tmp_path / "q.hgdb")
    jax_main(["search", "-r", str(tmp_path / "r.hgdb"), "-q",
              str(tmp_path / "q.hgdb"), "-o", str(tmp_path / "jax.tsv"),
              "--top_k", "5", "-a", "0", "-D", "cpu"])
    for name, res in (("got.tsv", got), ("direct.tsv", direct)):
        torch_search.write_search_tsv(tmp_path / name, ref.names, ref.norms,
                                      q, *res, 0.0)
        assert ((tmp_path / name).read_bytes()
                == (tmp_path / "jax.tsv").read_bytes())


def test_search_reads_no_host_array_for_its_mode(data, monkeypatch):
    """abs_bound sees only tensors (the uploaded queries and tiles) in
    topk_search and in a one-process multihost_topk_search, once for the
    queries and once for each tile's part on each device; never with
    mode=False."""
    from hypergen_tpu_torch.io.sketch_db import ShardedDB
    from hypergen_tpu_torch.ops import ani as tani

    seen = []
    orig = tani.abs_bound
    monkeypatch.setattr(tani, "abs_bound",
                        lambda a: seen.append(a) or orig(a))
    want = torch_search.topk_search(["cpu"], *data, 21, 4, mode=False)
    assert seen == []
    db = ShardedDB(ksize=21, scaled=1500, canonical=True, seed=123, hv_d=96,
                   names=[f"r{i}" for i in range(10)], hvs=data[0],
                   norms=data[1])
    for search, parts in (
            # tiles of 4 rows, 2 a device: 3 tiles on 2 devices
            (lambda: torch_search.topk_search(["cpu"] * 2, *data, 21, 4,
                                              mode=True, tile_rows=4), 6),
            # one tile of the process's 10 rows, 5 a device
            (lambda: torch_search.multihost_topk_search(
                db, *data[2:], 21, 4, ["cpu"] * 2, mode=True), 2)):
        seen.clear()
        got = search()
        assert len(seen) == 1 + parts
        assert all(isinstance(a, torch.Tensor) for a in seen)
        np.testing.assert_array_equal(seen[0].numpy(), data[2])
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
