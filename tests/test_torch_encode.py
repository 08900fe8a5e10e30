"""HV encode, i16 wrap and wrapping-i32 norm^2 of the PyTorch port against
the JAX package's: the plain functions of ops/encode.py, and the encode
kernel's wrapper (ops/kernels/encode_kernel.py), which runs its plain
version for a CPU tensor. Tolerance: exact equality of integers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from hypergen_tpu.ops import encode as jax_encode
from hypergen_tpu.ops import u64 as ju
from hypergen_tpu_torch.ops import encode as te
from hypergen_tpu_torch.ops.kernels import encode_kernel as ek
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


# -- the encode kernel's wrapper (ops/kernels/encode_kernel.py) ---------------


def _jax_encode_i16(h, valid, hv_d):
    """The JAX package's encode, i16 wrap and norm^2, as numpy."""
    hv16 = jax_encode.hv_to_i16(jax_encode.encode_hv(
        ju.from_np_u64(h), jnp.asarray(valid), hv_d))
    return np.asarray(hv16), np.asarray(jax_encode.hv_norm2_i32(hv16))


def _rows(case, seed):
    """(h uint64 [B, N], valid bool [B, N]) of a case; B odd, N a multiple
    of no block (PLAIN_BLOCK, the JAX block, the kernel's tile), and row 1
    with no valid entry."""
    rng = np.random.default_rng(seed)
    B, N = (3, 1001) if case == "ragged" else (3, 40_003)
    h = rng.integers(0, 2**64 - 1, size=(B, N), dtype=np.uint64,
                     endpoint=True)
    valid = rng.random((B, N)) < 0.45
    valid[1] = False
    if case == "wrap":  # one hash 40,000 times: the i16 and i32 wraps happen
        h[0] = h[0, 0]
        valid[0] = False
        valid[0, :40_000] = True
    return h, valid


@pytest.mark.parametrize("case", ["ragged", "wrap"])
@pytest.mark.parametrize("hv_d", [256, 4096])
def test_encode_hv_i16_matches_jax(hv_d, case):
    h, valid = _rows(case, hv_d)
    before = ek.encode_hv_i16.launches
    hv16, norm2 = ek.encode_hv_i16(tu.from_numpy(h), torch.from_numpy(valid),
                                   hv_d)
    assert ek.encode_hv_i16.launches == before  # the CPU runs the plain path
    want_hv, want_n2 = _jax_encode_i16(h, valid, hv_d)
    assert hv16.dtype == torch.int16 and norm2.dtype == torch.int32
    np.testing.assert_array_equal(hv16.numpy(), want_hv)
    np.testing.assert_array_equal(norm2.numpy(), want_n2)
    assert not hv16[1].any() and norm2[1] == 0
    if case == "wrap":
        # every dimension is +-40000, which wraps to -+25536
        assert set(np.abs(hv16[0].numpy()).tolist()) == {65_536 - 40_000}
        assert (hv16[0].numpy().astype(np.int64) ** 2).sum() > 2**31


@pytest.mark.parametrize("hv_d", [256, 4096])
def test_combine_i16_equals_one_encode_of_the_union(hv_d):
    """The seqpar combine: two disjoint slabs' int16 HVs, summed in int32
    and wrapped again, equal one encode of their union (the first slab
    wraps on its own)."""
    rng = np.random.default_rng(hv_d + 7)
    h = rng.integers(0, 2**64 - 1, size=(1, 41_000), dtype=np.uint64,
                     endpoint=True)
    h[0, :40_000] = h[0, 0]  # one repeated hash: its slab wraps alone
    th = tu.from_numpy(h)
    ones = torch.ones_like(th, dtype=torch.bool)
    a = ek.encode_hv_i16(th[:, :40_500].contiguous(), ones[:, :40_500], hv_d)
    b = ek.encode_hv_i16(th[:, 40_500:].contiguous(), ones[:, 40_500:], hv_d)
    hv16, norm2 = ek.combine_i16([a[0], b[0]])
    want_hv, want_n2 = _jax_encode_i16(h, ones.numpy(), hv_d)
    np.testing.assert_array_equal(hv16.numpy(), want_hv)
    np.testing.assert_array_equal(norm2.numpy(), want_n2)
    assert hv16.dtype == torch.int16 and norm2.dtype == torch.int32


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_encode_hv_i16_dispatch(device):
    """A CPU tensor takes the plain version and launches nothing; a tensor
    on a device without the kernel raises, it falls back to nothing."""
    h = torch.zeros((2, 10), dtype=torch.int64, device=device)
    valid = torch.ones((2, 10), dtype=torch.bool, device=device)
    before = ek.encode_hv_i16.launches
    if device == "meta":
        with pytest.raises(ValueError, match="no encode kernel"):
            ek.encode_hv_i16(h, valid, 256)
    else:
        hv16, norm2 = ek.encode_hv_i16(h, valid, 256)
        want = ek.encode_hv_i16_plain(h, valid, 256)
        assert torch.equal(hv16, want[0]) and torch.equal(norm2, want[1])
    assert ek.encode_hv_i16.launches == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "strided", "hv_d"])
def test_encode_hv_i16_rejects(bad):
    h = torch.zeros((2, 10), dtype=torch.int64)
    valid = torch.ones((2, 10), dtype=torch.bool)
    hv_d = 256
    if bad == "dtype":
        h = h.to(torch.int32)
    elif bad == "shape":
        valid = valid[:, :9]
    elif bad == "strided":
        h = torch.zeros((2, 20), dtype=torch.int64)[:, ::2]
    else:
        hv_d = 100
    with pytest.raises(ValueError):
        ek.encode_hv_i16(h, valid, hv_d)


@pytest.mark.parametrize("route", ["step", "tiled", "seqpar"])
def test_every_route_encodes_through_the_wrapper(route, monkeypatch):
    """The step, the tiled route and seqpar each call encode_hv_i16 (once a
    batch, once a genome, once a slab) and give what they gave before."""
    from hypergen_tpu_torch.io.fastx import packed_from_codes
    from hypergen_tpu_torch.models import sketcher as ts
    from hypergen_tpu_torch.params import SketchParams
    from hypergen_tpu_torch.parallel import seqpar

    calls = []

    def spy(h, valid, hv_d):
        calls.append(tuple(h.shape))
        return ek.encode_hv_i16(h, valid, hv_d)

    monkeypatch.setattr(ts, "encode_hv_i16", spy)
    monkeypatch.setattr(seqpar, "encode_hv_i16", spy)
    rng = np.random.default_rng(31)
    codes = rng.integers(0, 4, size=20_000).astype(np.uint8)
    p = SketchParams(scaled=40, hv_d=256)
    sk = ts.Sketcher(p, device="cpu", chunk_positions=2048, batch=2)
    if route == "step":
        got = sk.sketch_batch([packed_from_codes(codes)])[0]
        want_calls = 1
    elif route == "tiled":
        got = sk.sketch_packed_tiled(packed_from_codes(codes), tile_chunks=2)
        want_calls = 1
    else:
        got = seqpar.sketch_codes_seqpar(codes, p, ["cpu"] * 3,
                                         chunk_positions=2048)
        want_calls = 3
    assert len(calls) == want_calls
    monkeypatch.undo()
    ref = ts.Sketcher(p, device="cpu", chunk_positions=2048,
                      batch=2).sketch_batch([packed_from_codes(codes)])[0]
    np.testing.assert_array_equal(got["hv"], ref["hv"])
    assert got["norm2"] == ref["norm2"] and got["n_hashes"] == ref["n_hashes"]


# -- the kernel's launch plan and ticket buffer, decided on the host -----------


@settings(max_examples=300, deadline=None)
@given(B=st.integers(0, 70_000), N=st.integers(0, 1 << 24),
       hv_d=st.integers(1, 160).map(lambda w: 64 * w))
def test_encode_slab_plan(B, N, hv_d):
    """1 to 64 slabs a row; more than one only when each gets MIN_TILES
    tiles or more and the launch stays within MAX_BLOCKS blocks; and the
    scratch holds every block's sums and every word group's squares."""
    S = ek.slab_plan(B, N, hv_d)
    G = ek.word_groups(hv_d)
    tiles = -(-N // ek.TILE)
    assert G == -(-hv_d // 512) and 1 <= S <= ek.MAX_SLABS
    assert S == 1 or (tiles >= S * ek.MIN_TILES
                      and S * G * B <= ek.MAX_BLOCKS)
    assert ek.scratch_words(B, S, hv_d) == B * G * (S * 512 + 1)


@pytest.mark.parametrize("B,N,S", [(8, 6144, 6), (1, 179_712, 64),
                                   (1, 1_453_769, 64), (64, 6144, 4),
                                   (5, 0, 1)])
def test_encode_slab_plan_at_the_path_shapes(B, N, S):
    """The plan at D = 4096 for the 16-genome step's inputs, the 2^27 bp
    one-row step's, the 2.18 Gbp genome's tiled encode, a 64-row batch
    and rows without slots; encode_outputs plans once and sizes the
    scratch and the outputs by that plan."""
    assert ek.slab_plan(B, N, 4096) == S
    plan, scratch, hv16, norm2 = ek.encode_outputs(B, N, 4096, "cpu")
    assert plan == S and scratch.dtype == torch.int32
    assert scratch.numel() == B * 8 * (S * 512 + 1)
    assert hv16.shape == (B, 4096) and hv16.dtype == torch.int16
    assert norm2.shape == (B,) and norm2.dtype == torch.int32


@pytest.mark.parametrize("geometry", [(128, 512, 64), (256, 512, 64),
                                      (128, 1024, 64), (128, 512, 32)])
def test_encode_entry_checks_the_kernel_geometry(monkeypatch, geometry):
    """The wrapper binds the kernel only when the kernel's tile, word group
    and slab limit are the ones its plan and buffer sizes assume."""
    from hypergen_tpu_torch.ops.kernels import build

    class Lib:
        class hg_encode_hv_i16:  # noqa: N801 - a C function's name
            pass

        @staticmethod
        def hg_encode_geometry(out):
            out[:] = geometry

    monkeypatch.setattr(build, "load", lambda name: Lib)
    if geometry == (ek.TILE, ek.GROUP_DIMS, ek.MAX_SLABS):
        assert ek._entry.__wrapped__() is Lib.hg_encode_hv_i16
    else:
        with pytest.raises(RuntimeError, match="geometry"):
            ek._entry.__wrapped__()


def test_encode_ticket_buffer_grows_and_is_kept(monkeypatch):
    """One zeroed buffer per (device, stream): reused while it holds
    B * (G + 1) tickets, replaced by a larger zeroed one when it does not,
    never shared between two streams."""
    monkeypatch.setattr(ek, "_tickets", {})
    a = ek.ticket_buffer(8, 4096, "cpu", 1)
    assert a.dtype == torch.int32 and a.numel() >= 8 * 9 and not a.any()
    assert ek.ticket_buffer(8, 4096, "cpu", 1) is a
    assert ek.ticket_buffer(1, 64, "cpu", 1) is a
    other = ek.ticket_buffer(8, 4096, "cpu", 2)
    assert other is not a and other.data_ptr() != a.data_ptr()
    a[0] = 5  # a stale value must not survive a growth
    big = ek.ticket_buffer(64, 4096, "cpu", 1)
    assert big is not a and big.numel() >= 64 * 9 and not big.any()
    assert ek.ticket_buffer(8, 4096, "cpu", 1) is big
    assert ek.ticket_buffer(8, 4096, "cpu", 2) is other
