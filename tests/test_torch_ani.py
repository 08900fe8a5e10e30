"""Exact dot and the dist pair paths of the PyTorch port against the JAX
package's. Tolerance: equal int32 dots, indices and (i, j, float32 host
ANI) rows; the device float32 ANI of a top-k within 1e-4 ANI%%, because
XLA's float chain (its own log) and PyTorch's differ in the last bits.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypergen_tpu.io import sketch_db as jax_sketch_db
from hypergen_tpu.models.comparator import Comparator as JaxComparator
from hypergen_tpu.ops import ani as jax_ani
from hypergen_tpu.parallel.search import _resolve_mxu
from hypergen_tpu_torch.io.sketch_db import ShardedDB
from hypergen_tpu.ops.ani import dot_i16_exact as jax_dot
from hypergen_tpu_torch.models.comparator import Comparator, db_to_tensors
from hypergen_tpu_torch.ops import ani as torch_ani
from hypergen_tpu_torch.ops.ani import dot_i16_exact


def test_dot_matches_jax_including_i32_wrap():
    rng = np.random.default_rng(0)
    r = rng.integers(-32768, 32768, size=(5, 4096)).astype(np.int16)
    q = rng.integers(-32768, 32768, size=(3, 4096)).astype(np.int16)
    r[0], q[0] = 32767, 32767  # 4096 * (2^15-1)^2 wraps i32
    r[1], q[1] = -32768, 32767
    got = dot_i16_exact(torch.from_numpy(r), torch.from_numpy(q))
    assert got.dtype == torch.int32
    want = np.asarray(jax_dot(jnp.asarray(r), jnp.asarray(q), use_mxu=False))
    np.testing.assert_array_equal(got.numpy(), want)
    exact = r.astype(np.int64) @ q.astype(np.int64).T
    assert abs(int(exact[0, 0])) > 2**31
    np.testing.assert_array_equal(got.numpy(), exact.astype(np.int32))


def _db(seed, n, hv_d=512, pool=1200, span=300, names="g"):
    """A sketch DB whose HVs bundle random +-1 vectors from overlapping
    windows of one pool, so pair ANIs spread across the report thresholds
    (from 0 for disjoint windows to ~99)."""
    vecs = np.random.default_rng(0).choice(
        np.array([-1, 1], np.int64), size=(pool, hv_d))
    rng = np.random.default_rng(seed)
    hvs = np.zeros((n, hv_d), np.int64)
    for i in range(n):
        lo = int(rng.integers(0, pool - span))
        take = rng.random(span) < 0.9
        hvs[i] = vecs[lo : lo + span][take].sum(0)
    hvs = hvs.astype(np.int16)
    norms = (hvs.astype(np.int64) ** 2).sum(-1).astype(np.int32)
    return ShardedDB(ksize=21, scaled=1500, canonical=True, seed=123,
                     hv_d=hv_d, names=[f"{names}{i}" for i in range(n)],
                     hvs=hvs, norms=norms)


def _jax_db(db):
    """The JAX package's ShardedDB holding the same fields as the port's."""
    return jax_sketch_db.ShardedDB(**dataclasses.asdict(db))


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("threshold", [0.0, 85.0, 95.0])
def test_pair_paths_match_jax(symmetric, threshold):
    ref = _db(1, 11)
    qry = ref if symmetric else _db(2, 7, names="q")
    jc = JaxComparator(ksize=21, tile_m=4, tile_n=4, use_mxu=False)
    tc = Comparator(ksize=21, device="cpu", tile_m=4, tile_n=4)
    jref, jqry = _jax_db(ref), _jax_db(qry)
    if threshold >= 50:
        want = jc.ani_pairs_thresholded(jref, jqry, symmetric, threshold)
        got = tc.ani_pairs_thresholded(ref, qry, symmetric, threshold)
    else:
        want = jc.ani_pairs_streamed(jref, jqry, symmetric, threshold)
        got = tc.ani_pairs_streamed(ref, qry, symmetric, threshold)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    assert got[2].dtype == np.float32
    assert got[3] == want[3]
    assert 0 < got[0].size < got[3] or threshold == 0.0


def test_db_to_tensors_keeps_bits():
    db = _db(3, 4)
    hvs, norms = db_to_tensors(db, "cpu")
    assert hvs.dtype == torch.int16 and norms.dtype == torch.int32
    np.testing.assert_array_equal(hvs.numpy(), db.hvs)
    np.testing.assert_array_equal(norms.numpy(), db.norms)


def _extreme_pair(seed, m, n, d, bound):
    """int16 r [m, d], q [n, d] uniform in [-bound, bound], with rows of
    the extremes: -32768, 32767, +-6175 and +-6176 where the bound allows,
    so that the products and the combines wrap int32."""
    rng = np.random.default_rng(seed)
    lo, hi = (-32768, 32767) if bound is None else (-bound, bound)
    r = rng.integers(lo, hi + 1, size=(m, d)).astype(np.int16)
    q = rng.integers(lo, hi + 1, size=(n, d)).astype(np.int16)
    extremes = [v for v in (-32768, 32767, 6175, -6175, 6176, -6176)
                if lo <= v <= hi]
    for i, v in enumerate(extremes):
        r[i % m] = v
        q[(i + 1) % n] = v
        r[(i + 2) % m, ::2] = -v if -v <= hi else v
    return r, q


def _jx(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(a)


# (mode, value bound): "small" only within SMALL_SPLIT_MAX
DOT_CASES = [("small", 6175), (True, 6175), (True, None), (False, None)]


@pytest.mark.parametrize("d", [4096, 37, 8])
@pytest.mark.parametrize("mode,bound", DOT_CASES)
def test_int8_modes_match_jax(mode, bound, d):
    """Each mode of dot_i16_exact equals the JAX package's use_mxu of the
    same name bit for bit, at the int16 and split extremes, and at depths
    that are and are not multiples of 8."""
    r, q = _extreme_pair(d + (bound or 0), 21, 9, d, bound)
    got = dot_i16_exact(_t(r), _t(q), mode)
    assert got.dtype == torch.int32
    want = np.asarray(jax_dot(_jx(r), _jx(q), use_mxu=mode))
    np.testing.assert_array_equal(got.numpy(), want)
    exact = (r.astype(np.int64) @ q.astype(np.int64).T).astype(np.int32)
    np.testing.assert_array_equal(got.numpy(), exact)


@pytest.mark.parametrize("d", [4096, 37])
def test_presplit_forms_match_jax(d):
    """The presplit planes and row correction, the presplit dots, and
    dot_i16_any on a SmallSplit with an over-bound query (the rebuild of
    the exact rows) in every mode, against the JAX package."""
    r, _ = _extreme_pair(1, 19, 7, d, 6175)
    _, q_small = _extreme_pair(2, 19, 7, d, 6175)
    _, q_wide = _extreme_pair(3, 19, 7, d, None)
    jsplit = jax_ani.presplit_rows(_jx(r))
    tsplit = torch_ani.presplit_rows(_t(r))
    for a, b in zip(tsplit, jsplit):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jsmall = jax_ani.presplit_rows_small(_jx(r))
    tsmall = torch_ani.presplit_rows_small(_t(r))
    for a, b in zip(tsmall, jsmall):
        assert a.dtype == torch.int8
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for q in (q_small, q_wide):
        np.testing.assert_array_equal(
            torch_ani.dot_i16_presplit(*tsplit, _t(q)).numpy(),
            np.asarray(jax_ani.dot_i16_presplit(*jsplit, _jx(q))))
    np.testing.assert_array_equal(
        torch_ani.dot_i16_presplit_small(tsmall, _t(q_small)).numpy(),
        np.asarray(jax_ani.dot_i16_presplit_small(jsmall, _jx(q_small))))
    for q, mode in ((q_small, "small"), (q_wide, True), (q_wide, False)):
        got = torch_ani.dot_i16_any(tsmall, _t(q), mode)
        want = jax_ani.dot_i16_any(jsmall, _jx(q), use_mxu=mode)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        got = torch_ani.dot_i16_any(tsplit, _t(q), mode)
        want = jax_ani.dot_i16_any(jsplit, _jx(q), use_mxu=mode)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("top", [6175, 6176, 32767])
def test_resolve_mode_matches_jax(top):
    """None resolves to the int8 split on a CUDA device (the 3-product one
    when every value fits) and to the direct dot on the CPU; True upgrades
    as the JAX package's _resolve_mxu."""
    a = np.zeros((3, 8), np.int16)
    b = np.zeros((2, 8), np.int16)
    b[1, 3] = -top
    want = _resolve_mxu(True, a, b)
    assert torch_ani.resolve_mode(None, "cuda", _t(a), _t(b)) == want
    assert torch_ani.resolve_mode(True, "cpu", _t(a), _t(b)) == want
    assert torch_ani.resolve_mode(None, "cpu", _t(a), _t(b)) is False
    assert torch_ani.resolve_mode("small", "cuda", _t(a)) == "small"
    assert torch_ani.abs_bound(_t(b)) == top


def test_topk_desc_matches_lax_top_k():
    """Ties (equal values, -inf, 0, 100) rank the lower position first and
    the lower positions make the cut, as jax.lax.top_k."""
    import jax

    rng = np.random.default_rng(5)
    x = rng.choice(np.array([0.0, 100.0, 97.5, -np.inf, 3.25], np.float32),
                   size=(6, 40))
    x[0, :] = 97.5
    for k in (1, 5, 40):
        v, p = torch_ani.topk_desc(_t(x), k)
        jv, jp = jax.lax.top_k(_jx(x), k)
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def _dup_db(seed, n, hv_d=64, names="g"):
    """_db with exact copies of rows: equal device ANIs at the k-th place."""
    db = _db(seed, n, hv_d=hv_d, names=names)
    db.hvs[3] = db.hvs[1]
    db.hvs[n - 1] = db.hvs[1]
    db.hvs[4] = db.hvs[2]
    db.norms = (db.hvs.astype(np.int64) ** 2).sum(-1).astype(np.int32)
    return db


@pytest.mark.parametrize("mode", ["small", True, False])
@pytest.mark.parametrize("k", [1, 2, 4, 9])
def test_ani_topk_matches_jax(mode, k):
    """Winners (indices, exact dots) equal the JAX package's, duplicated
    rows at the k-th place included; device ANIs within 1e-4."""
    ref, qry = _dup_db(1, 9), _dup_db(2, 5, names="q")
    qry.hvs[0] = ref.hvs[1]
    qry.norms = (qry.hvs.astype(np.int64) ** 2).sum(-1).astype(np.int32)
    args = (ref.hvs, ref.norms, qry.hvs, qry.norms)
    v, i, d = torch_ani.ani_topk(*map(_t, args), 21, k, mode)
    jv, ji, jd = jax_ani.ani_topk(*map(_jx, args), 21, k, use_mxu=mode)
    assert i.dtype == d.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=1e-4)
    assert int(i[0, 0]) == 1 and float(v[0, 0]) == 100.0
    np.testing.assert_allclose(
        torch_ani.ani_matrix(*map(_t, args), 21, mode).numpy(),
        np.asarray(jax_ani.ani_matrix(*map(_jx, args), 21, use_mxu=mode)),
        rtol=0, atol=1e-4)


@pytest.mark.parametrize("mode", ["small", True, False])
def test_dot_tiles_and_dense_pairs_match_jax(mode):
    """dot_tiles over preloaded resident tiles (SmallSplit, 4-way or raw)
    and ani_pairs, against the JAX Comparator with the same mode."""
    ref, qry = _db(1, 11), _db(2, 7, names="q")
    jc = JaxComparator(ksize=21, tile_m=4, tile_n=3, use_mxu=mode)
    tc = Comparator(ksize=21, device="cpu", tile_m=4, tile_n=3, mode=mode)
    assert tc.dot_mode(_t(ref.hvs), _t(qry.hvs)) == jc.dot_mode(ref.hvs,
                                                                qry.hvs)
    blocks = tc.preload_rows(ref.hvs)
    want = list(jc.dot_tiles(ref.hvs, qry.hvs))
    for got in (list(tc.dot_tiles(ref.hvs, qry.hvs)),
                list(tc.dot_tiles(ref.hvs, qry.hvs, r_blocks=blocks))):
        assert len(got) == len(want)
        for (mi, nj, a), (wmi, wnj, b) in zip(got, want):
            assert (mi, nj) == (wmi, wnj)
            np.testing.assert_array_equal(a, b)
    for sym, q in ((True, ref), (False, qry)):
        for a, b in zip(tc.ani_pairs(ref, q, sym),
                        jc.ani_pairs(_jax_db(ref), _jax_db(q), sym)):
            np.testing.assert_array_equal(a, b)
    tc.MAX_DENSE_PAIRS = 10
    with pytest.raises(ValueError):
        tc.ani_pairs(ref, qry, False)


@pytest.mark.parametrize("mode", ["small", True, False])
@pytest.mark.parametrize("threshold", [0.0, 90.0])
def test_pair_paths_offsets_and_blocks_match_jax(mode, threshold):
    """ani_pairs_thresholded/_streamed with ref_blocks, ref_offset and
    query_offset (a pod's rectangle of a symmetric dist) against JAX."""
    full = _db(4, 12)
    ref = dataclasses.replace(full, names=full.names[5:], hvs=full.hvs[5:],
                              norms=full.norms[5:])
    qry = dataclasses.replace(full, names=full.names[2:9], hvs=full.hvs[2:9],
                              norms=full.norms[2:9])
    jc = JaxComparator(ksize=21, tile_m=3, tile_n=2, use_mxu=mode)
    tc = Comparator(ksize=21, device="cpu", tile_m=3, tile_n=2, mode=mode)
    kw = dict(symmetric=True, threshold=threshold, ref_offset=5,
              query_offset=2)
    if threshold >= 50:
        got = tc.ani_pairs_thresholded(ref, qry, ref_blocks=tc.preload_ref(ref),
                                       **kw)
        want = jc.ani_pairs_thresholded(_jax_db(ref), _jax_db(qry), **kw)
    else:
        got = tc.ani_pairs_streamed(ref, qry, ref_blocks=tc.preload_rows(
            ref.hvs), **kw)
        want = jc.ani_pairs_streamed(_jax_db(ref), _jax_db(qry), **kw)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    assert got[0].size > 0



def test_reference_is_scanned_once_a_dist_call(monkeypatch):
    """abs_bound reads the reference's bound once a dist call, from the
    row tiles' bounds reduced where they were uploaded (when it is
    preloaded; in a symmetric call the query is the reference's own array
    and is not read), and not the reference when its resident blocks are
    passed in: then each query tile on the device. It never sees a host
    array."""
    from hypergen_tpu_torch.models import comparator as comp_mod

    scanned = []
    orig = torch_ani.abs_bound
    monkeypatch.setattr(torch_ani, "abs_bound",
                        lambda a: scanned.append(a) or orig(a))
    ref, qry = _db(1, 11), _db(2, 7, names="q")
    tc = Comparator(ksize=21, device="cpu", tile_m=4, tile_n=3, mode=True)
    got = tc.ani_pairs_thresholded(ref, ref, True, 85.0)
    tile_bounds = [int(np.abs(ref.hvs[mi : mi + 4].astype(np.int32)).max())
                   for mi in range(0, 11, 4)]
    assert len(scanned) == 1 and isinstance(scanned[0], torch.Tensor)
    assert scanned[0].tolist() == tile_bounds
    blocks = tc.preload_ref(ref)
    assert isinstance(blocks[0][0], torch_ani.SmallSplit)
    scanned.clear()
    tc.ani_pairs_thresholded(ref, qry, False, 85.0, ref_blocks=blocks)
    tc.ani_pairs_streamed(ref, qry, False, 0.0,
                          ref_blocks=tc.preload_rows(ref.hvs))
    assert all(isinstance(a, torch.Tensor) for a in scanned)
    q_tiles = [qry.hvs[nj : nj + 3] for nj in range(0, 7, 3)]
    assert len(scanned) == 7
    for a, q in zip(scanned[:3] + scanned[4:], q_tiles + q_tiles):
        np.testing.assert_array_equal(a.numpy(), q)
    assert scanned[3].tolist() == tile_bounds  # preload_rows, not the call
    want = comp_mod.Comparator(ksize=21, device="cpu", tile_m=4, tile_n=3,
                               mode=False).ani_pairs_thresholded(
                                   ref, ref, True, 85.0)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("over", [6176, -32768, 32767])
def test_over_bound_query_against_small_tiles_is_the_direct_dot(over):
    """A query past SMALL_SPLIT_MAX against SmallSplit resident tiles (a
    reference that fits) gives the direct dot's bytes on every pair path."""
    ref, qry = _db(1, 11), _db(2, 7, names="q")
    qry.hvs[3, 5] = over
    qry.norms = (qry.hvs.astype(np.int64) ** 2).sum(-1).astype(np.int32)
    tc = Comparator(ksize=21, device="cpu", tile_m=4, tile_n=3, mode=True)
    direct = Comparator(ksize=21, device="cpu", tile_m=4, tile_n=3,
                        mode=False)
    blocks = tc.preload_rows(ref.hvs)
    assert isinstance(blocks[0], torch_ani.SmallSplit)
    q_tiles = [torch.from_numpy(qry.hvs[nj : nj + 3]) for nj in (0, 3, 6)]
    assert [tc._query_mode(blocks[0], q, False)
            for q in q_tiles] == ["small", True, "small"]
    want = (ref.hvs.astype(np.int64) @ qry.hvs.astype(np.int64).T)
    want = ((want + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)
    for mi, nj, tile in tc.dot_tiles(ref.hvs, qry.hvs, r_blocks=blocks):
        np.testing.assert_array_equal(
            tile, want[mi : mi + tile.shape[0], nj : nj + tile.shape[1]])
    for name, th in (("ani_pairs_thresholded", 85.0),
                     ("ani_pairs_streamed", 0.0)):
        got = getattr(tc, name)(ref, qry, False, th)
        for a, b in zip(got, getattr(direct, name)(ref, qry, False, th)):
            np.testing.assert_array_equal(a, b)


def test_splits_match_jax_on_every_int16():
    """Both splits give the JAX package's int8 planes for all 65,536 int16
    values (the 3-product split also past its bound, where both wrap)."""
    x = np.arange(-32768, 32768, dtype=np.int64).astype(np.int16).reshape(
        256, 256)
    for tsplit, jsplit in ((torch_ani.split_i16_to_i8, jax_ani.split_i16_to_i8),
                           (torch_ani._split_small, jax_ani._split_small)):
        for a, b in zip(tsplit(_t(x)), jsplit(_jx(x))):
            assert a.dtype == torch.int8
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _straddling_db(seed, n, names="g"):
    """_db with rows 5 (6176) and 9 (-32768) past SMALL_SPLIT_MAX: at
    tile_m=4 the second and the third row tile, the first fitting."""
    db = _db(seed, n, names=names)
    db.hvs[5, 7], db.hvs[9, 2] = 6176, -32768
    db.norms = (db.hvs.astype(np.int64) ** 2).sum(-1).astype(np.int32)
    return db


@pytest.mark.parametrize("path,threshold", [("ani_pairs_thresholded", 85.0),
                                            ("ani_pairs_streamed", 0.0)])
def test_straddling_dist_matches_direct_and_jax(tmp_path, path, threshold):
    """With mode=True, a collection whose row tiles straddle the bound
    takes the 4-way split in every tile (one mode for the resident tiles),
    and a query tile past the bound against fitting tiles takes it for
    that query tile only; the pairs and the TSV equal mode=False's and the
    JAX package's, and each product counts its split."""
    from hypergen_tpu.models.comparator import (
        write_ani_report as jax_write_ani_report)
    from hypergen_tpu_torch.models.comparator import write_ani_report
    from hypergen_tpu_torch.utils.timing import COUNTERS, SPANS

    coll, fit, qry = _straddling_db(1, 11), _db(1, 11), _db(2, 7, names="q")
    qry.hvs[4, 3] = 6176  # the second of three query tiles of 3
    qry.norms = (qry.hvs.astype(np.int64) ** 2).sum(-1).astype(np.int32)
    tc = Comparator(ksize=21, device="cpu", tile_m=4, tile_n=3, mode=True)
    direct = Comparator(ksize=21, device="cpu", tile_m=4, tile_n=3,
                        mode=False)
    jc = JaxComparator(ksize=21, tile_m=4, tile_n=3, use_mxu=True)
    # (ref, query, symmetric, products with a fitting query tile)
    for ref, q, sym, small in ((coll, coll, True, 0), (fit, qry, False, 6)):
        before = (COUNTERS.dot_tiles_small, COUNTERS.dot_tiles_split4,
                  SPANS.dist_fetch.n)
        got = getattr(tc, path)(ref, q, sym, threshold)
        products = SPANS.dist_fetch.n - before[2]
        assert products == (8 if sym else 9)  # 4 of 12 below the diagonal
        assert (COUNTERS.dot_tiles_small - before[0],
                COUNTERS.dot_tiles_split4 - before[1]) == (small,
                                                           products - small)
        want = getattr(jc, path)(_jax_db(ref), _jax_db(q), sym, threshold)
        for a, b, c in zip(got, getattr(direct, path)(ref, q, sym, threshold),
                           want):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, np.asarray(c))
        assert got[0].size > 0
        write_ani_report(tmp_path / "got.tsv", ref.names, q.names,
                         *got[:3], threshold)
        jax_write_ani_report(tmp_path / "jax.tsv", ref.names, q.names,
                             *(np.asarray(x) for x in want[:3]), threshold)
        assert ((tmp_path / "got.tsv").read_bytes()
                == (tmp_path / "jax.tsv").read_bytes())
