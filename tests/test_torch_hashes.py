"""Hash primitives of the PyTorch port against the oracle, the golden vectors
and the JAX package's ops. Tolerance: exact equality of every bit."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from hypergen_tpu.oracle import mm_hash64 as oracle_mm_hash64
from hypergen_tpu.oracle import t1ha2_atonce, wyrng_words
from hypergen_tpu.ops import hashes as jax_hashes
from hypergen_tpu.ops import u64 as ju
from hypergen_tpu_torch.ops import hashes as th
from hypergen_tpu_torch.ops import u64 as tu

M64 = (1 << 64) - 1
EDGES = [0, 1, 2, 0xFFFFFFFF, 1 << 32, (1 << 63) - 1, 1 << 63, M64 - 1, M64]

# t1ha2_atonce of canonical 21-mers under seed 123 (tests/test_oracle.py)
T1HA2_KMER_GOLDEN = {
    b"ACGTACGTACGTACGTACGTA": 11926153409282979023,
    b"TTTTTTTTTTTTTTTTTTTTT": 11344018742526983605,
    b"GATTACAGATTACAGATTACA": 6893802557166114521,
}


def _t(values):
    return tu.from_numpy(np.array(values, dtype=np.uint64))


def _le_words(data: bytes):
    """Little-endian u64 words of `data`, the last zero-padded."""
    return [
        int.from_bytes(data[i : i + 8], "little")
        for i in range(0, len(data), 8)
    ]


@pytest.mark.parametrize("length", range(1, 33))
def test_t1ha2_words_match_oracle_and_jax(length):
    rng = np.random.default_rng(length)
    datas = [rng.integers(0, 256, size=length, dtype=np.uint8).tobytes()
             for _ in range(6)]
    seeds = [0, 123, M64, 42424242]
    cols = list(zip(*[_le_words(d) for d in datas]))  # per word: 6 values
    for seed in seeds:
        got = tu.to_numpy(th.t1ha2_atonce_words([_t(c) for c in cols],
                                                length, seed))
        want = [t1ha2_atonce(d, seed) for d in datas]
        assert got.tolist() == want
        jw = [ju.from_np_u64(np.array(c, np.uint64)) for c in cols]
        jax_got = ju.to_np_u64(jax_hashes.t1ha2_atonce_words(jw, length, seed))
        assert jax_got.tolist() == want


def test_t1ha2_kmer_golden_vectors():
    for kmer, expected in T1HA2_KMER_GOLDEN.items():
        words = [_t([w]) for w in _le_words(kmer)]
        got = tu.to_numpy(th.t1ha2_atonce_words(words, len(kmer), 123))
        assert int(got[0]) == expected


def test_mm_hash64_matches_oracle_and_jax():
    keys = EDGES + np.random.default_rng(3).integers(
        0, M64, size=64, dtype=np.uint64, endpoint=True).tolist()
    got = tu.to_numpy(th.mm_hash64(_t(keys))).tolist()
    assert got == [oracle_mm_hash64(k) for k in keys]
    jax_got = ju.to_np_u64(jax_hashes.mm_hash64(
        ju.from_np_u64(np.array(keys, np.uint64))))
    assert jax_got.tolist() == got


def test_wyrng_words_match_golden_and_jax():
    golden = json.loads(
        (Path(__file__).parent / "golden_wyrng.json").read_text()
    )["raw"]
    seeds = [int(s) for s in golden]
    offsets = th.wyrng_word_offsets(8)
    got = tu.to_numpy(th.wyrng_words_from_hash(_t(seeds), offsets))
    for i, s in enumerate(golden):
        assert got[i].tolist() == golden[s]
        assert got[i].tolist() == wyrng_words(int(s), 8)
    hi, lo = jax_hashes.wyrng_words_from_hash(
        ju.from_np_u64(np.array(seeds, np.uint64)),
        ju.from_np_u64(jax_hashes.wyrng_word_offsets(8)),
    )
    jax_got = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(
        lo).astype(np.uint64)
    np.testing.assert_array_equal(jax_got, got)


def test_u64_helpers_on_edge_values():
    a = _t([x for x in EDGES for _ in EDGES])
    b = _t([y for _ in EDGES for y in EDGES])
    pa = [x for x in EDGES for _ in EDGES]
    pb = [y for _ in EDGES for y in EDGES]
    assert tu.lt(a, b).tolist() == [x < y for x, y in zip(pa, pb)]
    assert tu.to_numpy(tu.mulhi(a, b)).tolist() == [
        (x * y) >> 64 for x, y in zip(pa, pb)]
    assert tu.to_numpy(a * b).tolist() == [(x * y) & M64 for x, y in zip(pa, pb)]
    assert tu.to_numpy(a + b).tolist() == [(x + y) & M64 for x, y in zip(pa, pb)]
    for c in (0, 1, 1 << 63, M64):
        assert tu.lt_const(a, c).tolist() == [x < c for x in pa]
        assert tu.to_numpy(tu.mulhi(a, c)).tolist() == [
            (x * c) >> 64 for x in pa]
    for s in (0, 1, 7, 31, 32, 33, 63):
        assert tu.to_numpy(tu.shr(a, s)).tolist() == [x >> s for x in pa]
    for s in (1, 23, 41, 63):
        assert tu.to_numpy(tu.rotr(a, s)).tolist() == [
            ((x >> s) | (x << (64 - s))) & M64 for x in pa]


def test_wrap_i32_and_i64():
    vals = [0, 1, -1, 2**31 - 1, 2**31, -(2**31), -(2**31) - 1, 2**42 + 5,
            -(2**42) - 5]
    got = tu.wrap_i32(torch.tensor(vals, dtype=torch.int64)).tolist()
    want = np.array(vals, dtype=np.int64).astype(np.int32).tolist()
    assert got == want
    assert [tu.i64(v) for v in (0, 1 << 63, M64)] == [0, -(1 << 63), -1]
    assert tu.from_numpy(np.array([M64], np.uint64)).dtype == torch.int64
