"""HV encode, i16 wrap and wrapping-i32 norm^2 of the PyTorch port against
the JAX package's. Tolerance: exact equality of integers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypergen_tpu.ops import encode as jax_encode
from hypergen_tpu.ops import u64 as ju
from hypergen_tpu_torch.ops import encode as te
from hypergen_tpu_torch.ops import u64 as tu


@pytest.mark.parametrize("csa", [False, True])
@pytest.mark.parametrize("hv_d,block", [(512, 64), (1024, 256)])
def test_encode_hv_matches_jax(hv_d, block, csa):
    rng = np.random.default_rng(hv_d + block)
    h = rng.integers(0, 2**64 - 1, size=(3, 300), dtype=np.uint64,
                     endpoint=True)
    valid = rng.random((3, 300)) < 0.7
    valid[2] = False  # an empty genome encodes to zero
    want = jax_encode.encode_hv(ju.from_np_u64(h), jnp.asarray(valid), hv_d,
                                block=block, csa=csa)
    got = te.encode_hv(tu.from_numpy(h), torch.from_numpy(valid), hv_d,
                       block=block)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[2].any()


def test_hv_to_i16_wraps_like_jax():
    x = np.array([0, 1, -1, 32767, 32768, -32768, -32769, 40000, -40000,
                  65535, 65536, 2**31 - 1, -(2**31)], dtype=np.int32)
    got = te.hv_to_i16(torch.from_numpy(x))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_encode.hv_to_i16(jnp.asarray(x))))
    assert got[7] == -25536


def test_hv_norm2_i32_wraps_like_jax():
    rng = np.random.default_rng(9)
    hv = rng.integers(-32768, 32768, size=(4, 4096)).astype(np.int16)
    hv[0] = 32767  # sum of squares 4096 * (2^15-1)^2 wraps i32 many times
    hv[1] = -32768
    hv[3] = rng.integers(-40, 40, size=4096)  # no wrap
    got = te.hv_norm2_i32(torch.from_numpy(hv))
    assert got.dtype == torch.int32
    want = np.asarray(jax_encode.hv_norm2_i32(jnp.asarray(hv)))
    np.testing.assert_array_equal(got.numpy(), want)
    exact = (hv.astype(np.int64) ** 2).sum(-1)
    assert (exact[:3] > 2**31).all() and exact[3] < 2**31
    np.testing.assert_array_equal(got.numpy(), exact.astype(np.int32))
