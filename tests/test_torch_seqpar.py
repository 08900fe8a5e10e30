"""The port's sequence-parallel sketch against the JAX package's, on the CPU.

The port splits one genome's chunks over ``["cpu"] * n``; the JAX side
shards them over a mesh of n of the conftest's virtual CPU devices, with
the Pallas K2 in interpret mode per shard. Both run at 512 positions a
chunk. The cases mirror tests/test_parallel.py::TestSeqPar: N runs across
chunk boundaries, identical content in every shard (cross-shard
duplicates), and scaled=1 (every valid k-mer survives). Tolerance 0: equal
hv, norm2 and n_hashes, also against the port's one-shot Sketcher.
"""

import jax
import numpy as np
import pytest
import torch

from hypergen_tpu.parallel import seqpar as jax_seqpar
from hypergen_tpu.params import SketchParams as JaxSketchParams
from hypergen_tpu_torch.io.fastx import packed_from_codes
from hypergen_tpu_torch.params import SketchParams
from hypergen_tpu_torch.models.sketcher import Sketcher
from hypergen_tpu_torch.parallel import seqpar

C = 512


def _params(cls=SketchParams, **kw):
    """The port's params (or, with cls, the JAX package's) for a case."""
    return cls(**{"ksize": 21, "seed": 123, "scaled": 30, "hv_d": 1024, **kw})


def _case(name):
    r = np.random.default_rng(len(name))
    if name == "runs":  # N runs inside a chunk and across a chunk boundary
        codes = r.integers(0, 4, size=24_000).astype(np.uint8)
        codes[5000:5040] = 4
        codes[20470:20490] = 4
        return codes, {}
    if name == "dups":  # the same block in every shard
        block = r.integers(0, 4, size=2048).astype(np.uint8)
        return np.concatenate([block] * 8), {}
    codes = r.integers(0, 4, size=6_000).astype(np.uint8)  # "scaled1"
    return codes, {"scaled": 1}


def _assert_same(a, b):
    np.testing.assert_array_equal(a["hv"], np.asarray(b["hv"]))
    assert a["norm2"] == int(b["norm2"])
    assert a["n_hashes"] == int(b["n_hashes"])


@pytest.mark.parametrize("name", ["runs", "dups", "scaled1"])
@pytest.mark.parametrize(
    "n", [1, 2, 4, pytest.param(8, marks=pytest.mark.needs_devices(8))])
def test_matches_jax_seqpar(n, name):
    codes, kw = _case(name)
    p = _params(**kw)
    got = seqpar.sketch_codes_seqpar(codes, p, ["cpu"] * n, chunk_positions=C)
    mesh = jax_seqpar.make_seq_mesh(jax.devices()[:n])
    want = jax_seqpar.sketch_codes_seqpar(
        codes, _params(JaxSketchParams, **kw), mesh, chunk_positions=C,
        use_pallas=True, pallas_interpret=True,
    )
    _assert_same(got, want)
    one_shot = Sketcher(p, device="cpu", chunk_positions=2048).sketch_batch(
        [packed_from_codes(codes)])[0]
    _assert_same(got, one_shot)
    if name == "scaled1":
        assert got["n_hashes"] > 5000


def test_chunk_codes_match_jax():
    codes = np.random.default_rng(3).integers(0, 5, size=3000).astype(np.uint8)
    for k, n_seq in ((21, 1), (21, 4), (32, 3), (15, 8)):
        np.testing.assert_array_equal(
            seqpar._chunk_codes(codes, k, C, n_seq),
            jax_seqpar._chunk_codes(codes, k, C, n_seq),
        )


def test_hash_chunks_launched_per_shard(monkeypatch):
    """Each shard runs K2 once, on the shard's own chunks."""
    calls = []
    orig = seqpar.hash_chunks

    def spy(codes, *a, **kw):
        calls.append(tuple(codes.shape))
        return orig(codes, *a, **kw)

    monkeypatch.setattr(seqpar, "hash_chunks", spy)
    codes, kw = _case("runs")  # 47 chunks -> padded to 48 over 4 shards
    seqpar.sketch_codes_seqpar(codes, _params(**kw), ["cpu"] * 4,
                               chunk_positions=C)
    assert calls == [(12, C + 20)] * 4


def test_tiny_and_empty_genomes():
    p = _params()
    for codes in (np.zeros(0, np.uint8), np.full(50, 4, np.uint8),
                  np.arange(30, dtype=np.uint8) % 4):
        got = seqpar.sketch_codes_seqpar(codes, p, ["cpu"] * 2,
                                         chunk_positions=C)
        want = Sketcher(p, device="cpu", chunk_positions=2048).sketch_batch(
            [packed_from_codes(codes)])[0]
        _assert_same(got, want)


def test_default_devices_are_cuda_cards(monkeypatch):
    """With no devices given, seqpar runs on every CUDA card, and raises
    when there is none instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        seqpar.sketch_codes_seqpar(np.zeros(100, np.uint8), _params())
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert seqpar._default_devices() == [
        torch.device("cuda", i) for i in range(3)]
