"""Exact dot and the dist pair paths of the PyTorch port against the JAX
package's. Tolerance: equal int32 dots and equal (i, j, float32 ANI) rows.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypergen_tpu.io import sketch_db as jax_sketch_db
from hypergen_tpu.models.comparator import Comparator as JaxComparator
from hypergen_tpu_torch.io.sketch_db import ShardedDB
from hypergen_tpu.ops.ani import dot_i16_exact as jax_dot
from hypergen_tpu_torch.models.comparator import Comparator, db_to_tensors
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
