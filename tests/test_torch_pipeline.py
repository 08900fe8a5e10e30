"""The port's asynchronous sketch API against the JAX package's, on the CPU.

``submit_batch_packed`` / ``submit_batch`` / ``submit`` return a handle
without waiting for the device; ``collect_batch`` / ``collect_batches`` /
``collect`` read it, check its capacities and rerun it when one
overflowed; ``sketch_files(pipeline_depth=n)`` keeps up to n batches in
flight. The JAX side runs as its own tests run it on the CPU
(``use_pallas=False``, and the packed path with ``pallas_interpret=True``).
Tolerance: exact equality of hv, norm2 and n_hashes, and of .sketch bytes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from hypergen_tpu import params as jax_params
from hypergen_tpu.io.fastx import packed_from_codes as jax_packed_from_codes
from hypergen_tpu.io import sketch_db as jdb
from hypergen_tpu.models import sketcher as jax_sketcher
from hypergen_tpu_torch.io import sketch_db as tdb
from hypergen_tpu_torch.io.fastx import INVALID, packed_from_codes
from hypergen_tpu_torch.models import sketcher as ts
from hypergen_tpu_torch.ops.compact import compact_masked, compact_to_width
from hypergen_tpu_torch.ops.kmers import hash_kmer_positions
from hypergen_tpu_torch.params import SketchParams

HV_D = 256
C = 2048


def _jax(p, batch, chunk_positions=C, **kw):
    kw.setdefault("use_pallas", False)
    return jax_sketcher.Sketcher(
        jax_params.SketchParams(**dataclasses.asdict(p)),
        chunk_positions=chunk_positions, batch=batch, **kw)


def _port(p, batch, chunk_positions=C, **kw):
    return ts.Sketcher(p, device="cpu", chunk_positions=chunk_positions,
                       batch=batch, **kw)


def _codes(rng, bp, n_runs=2):
    codes = rng.integers(0, 4, size=bp).astype(np.uint8)
    for _ in range(n_runs):
        s = int(rng.integers(0, max(bp - 60, 1)))
        codes[s : s + int(rng.integers(1, 50))] = INVALID
    return codes


def _assert_same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a["hv"].dtype == np.int16
        np.testing.assert_array_equal(a["hv"], np.asarray(b["hv"]))
        assert a["norm2"] == int(b["norm2"])
        assert a["n_hashes"] == int(b["n_hashes"])


def _flat(batches):
    return [r for batch in batches for r in batch]


# -- compaction to a fixed width -----------------------------------------------

@pytest.mark.parametrize("width", [1, 7, 30, 64])
def test_compact_to_width_matches_compact_masked(width):
    rng = np.random.default_rng(3)
    keep = torch.from_numpy(rng.random((5, 64)) < 0.4)
    keep[3] = False  # an empty row
    keep[4] = True  # a full row
    v = torch.from_numpy(rng.integers(-2**40, 2**40, size=(5, 64)))
    w = torch.from_numpy(rng.integers(0, 2**30, size=(5, 64)).astype(np.int32))
    (a, b), count = compact_to_width(keep, width, v, w)
    (ra, rb), rcount = compact_masked(keep, v, w)
    assert a.shape == (5, width) and a.dtype == v.dtype and b.dtype == w.dtype
    torch.testing.assert_close(count, rcount, rtol=0, atol=0)
    n = min(width, ra.shape[1])
    for got, want in ((a, ra), (b, rb)):
        torch.testing.assert_close(got[:, :n], want[:, :n], rtol=0, atol=0)
        assert (got[:, n:] == -1).all()


# -- submit and collect ------------------------------------------------------

ORDERS = {
    "submitted": lambda n: list(range(n)),
    "reversed": lambda n: list(range(n))[::-1],
    "shuffled": lambda n: list(np.random.default_rng(5).permutation(n)),
}


@pytest.mark.parametrize("order", list(ORDERS))
def test_collect_batches_matches_jax(order):
    """Three handles of two genomes, collected in any order; the port of
    test_collect_batches_matches_individual."""
    rng = np.random.default_rng(7)
    p = SketchParams(hv_d=HV_D, scaled=40)
    codes = [_codes(rng, 6000) for _ in range(6)]
    sk = _port(p, batch=2)
    handles = [sk.submit_batch(codes[i : i + 2]) for i in range(0, 6, 2)]
    idx = ORDERS[order](len(handles))
    got = dict(zip(idx, sk.collect_batches([handles[i] for i in idx])))
    jx = _jax(p, batch=2)
    want = jx.collect_batches(
        [jx.submit_batch(codes[i : i + 2]) for i in range(0, 6, 2)])
    _assert_same(_flat(got[i] for i in range(3)), _flat(want))
    assert sk.retries == {}


@pytest.mark.parametrize("order", ["submitted", "reversed"])
def test_collect_batches_mixed_row_counts(order):
    """Handles of 3, 1 and 2 genomes in three buckets, collected in either
    order, against the JAX package's one-at-a-time collect."""
    rng = np.random.default_rng(14)
    p = SketchParams(hv_d=HV_D, scaled=40)
    groups = [[_codes(rng, bp) for bp in (9000, 7000, 5000)],
              [_codes(rng, 2200)],
              [_codes(rng, 15000), _codes(rng, 30)]]
    sk = _port(p, batch=3)
    handles = [sk.submit_batch(g) for g in groups]
    assert [h.n for h in handles] == [3, 1, 2]
    assert [h.n_chunks for h in handles] == [8, 2, 8]
    idx = ORDERS[order](3)
    got = dict(zip(idx, sk.collect_batches([handles[i] for i in idx])))
    jx = _jax(p, batch=3)
    want = [jx.collect_batch(jx.submit_batch(g)) for g in groups]
    _assert_same(_flat(got[i] for i in range(3)), _flat(want))


def test_submit_and_collect_one_genome():
    rng = np.random.default_rng(15)
    p = SketchParams(hv_d=HV_D, scaled=40)
    codes = _codes(rng, 4000)
    sk = _port(p, batch=2)
    handle = sk.submit(codes)
    assert isinstance(handle, ts.SketchHandle) and handle.n == 1
    got = sk.collect(handle)
    jx = _jax(p, batch=2)
    _assert_same([got], [jx.collect(jx.submit(codes))])
    _assert_same([got], [sk.sketch_codes(codes)])


def test_submit_batch_packed_takes_packed_genomes():
    rng = np.random.default_rng(16)
    p = SketchParams(hv_d=HV_D, scaled=40)
    codes = [_codes(rng, 5000), _codes(rng, 3000)]
    sk = _port(p, batch=2)
    got = sk.collect_batch(
        sk.submit_batch_packed([packed_from_codes(c) for c in codes]))
    jx = _jax(p, batch=2)
    _assert_same(got, jx.collect_batch(jx.submit_batch(codes)))


@pytest.mark.parametrize("path", ["runs", "packed"])
def test_partial_batch_with_exact_length_row(path):
    """batch=3, one genome of exactly the padded bucket length (no run)
    and one 123 codes shorter, in one handle: the port of
    tests/test_bucket_corners.py's corner, against both JAX paths."""
    k = 17
    p = SketchParams(ksize=k, scaled=30, hv_d=HV_D)
    L_pad = -(-(C + k - 1) // 8) * 8
    rng = np.random.default_rng(11)
    g1 = rng.integers(0, 4, size=L_pad, dtype=np.uint8)
    g2 = rng.integers(0, 4, size=L_pad - 123, dtype=np.uint8)
    sk = _port(p, batch=3)
    got = sk.collect_batch(sk.submit_batch([g1, g2]))
    kw = ({"use_pallas": True, "pallas_interpret": True} if path == "packed"
          else {})
    jx = _jax(p, batch=3, **kw)
    _assert_same(got, jx.collect_batch(jx.submit_batch([g1, g2])))
    assert all(r["n_hashes"] > 0 for r in got)


@pytest.mark.parametrize("n", [0, 3])
def test_submit_rejects_empty_and_oversized_batches(n):
    p = SketchParams(hv_d=HV_D, scaled=40)
    codes = [np.zeros(100, np.uint8)] * n
    sk, jx = _port(p, batch=2), _jax(p, batch=2)
    for submit, pack in ((sk.submit_batch_packed, packed_from_codes),
                         (jx.submit_batch_packed, jax_packed_from_codes),
                         (sk.submit_batch, lambda c: c)):
        with pytest.raises(ValueError,
                           match=r"batch size must be in \[1, 2\]"):
            submit([pack(c) for c in codes])


def test_pack_buffers_outlive_later_submits():
    """More batches in flight than any pipeline depth: every handle keeps
    its own host buffer, and every result equals its batch sketched
    alone."""
    rng = np.random.default_rng(17)
    p = SketchParams(hv_d=HV_D, scaled=40)
    groups = [[_codes(rng, 3000 + 400 * i)] for i in range(5)]
    sk = _port(p, batch=1)
    handles = [sk.submit_batch(g) for g in groups]
    assert len({h.host.buf.data_ptr() for h in handles}) == len(handles)
    got = sk.collect_batches(handles[::-1])[::-1]
    for g, res in zip(groups, got):
        _assert_same(res, _port(p, batch=1).sketch_batch(
            [packed_from_codes(c) for c in g]))


# -- capacity overflow, retried at collect ----------------------------------

def test_cell_cap_overflow_retried_at_collect():
    """A tandem repeat whose k-mer passes scaled=50 fills its 32-position
    cells (C=4096) past the 6 slots; collect grows the cap and reruns only
    that handle."""
    rng = np.random.default_rng(8)
    p = SketchParams(scaled=50, hv_d=HV_D)
    rep = np.tile(np.array([0, 0, 1, 1], np.uint8), 600)  # (AACC)n
    g0 = _codes(rng, 9000)
    g0[3000 : 3000 + rep.size] = rep
    groups = [[g0, _codes(rng, 5000)], [_codes(rng, 7000)]]
    sk = _port(p, batch=2, chunk_positions=4096)
    handles = [sk.submit_batch(g) for g in groups]
    got = sk.collect_batches(handles[::-1])[::-1]
    assert sk.retries == {"cell_cap": 1}
    jx = _jax(p, batch=2, chunk_positions=4096)
    _assert_same(_flat(got), _flat(jx.collect_batches(
        [jx.submit_batch(g) for g in groups])))


def _width_repeat(rng, p, bp):
    """A genome of bp codes made of one 16-code unit repeated: every
    16-position cell holds the same 1-3 surviving windows, under the slot
    cap (4), while the genome's survivors (bp/16 and more) exceed the
    compaction width of its bucket."""
    while True:
        unit = rng.integers(0, 4, size=16).astype(np.uint8)
        window = torch.from_numpy(np.tile(unit, 4)[None, : 16 + p.ksize - 1])
        _, keep = hash_kmer_positions(window, p.ksize, p.seed, p.threshold)
        if 1 <= int(keep.sum()) <= 3:
            return np.tile(unit, -(-bp // 16))[:bp]


def test_width_overflow_retried_at_collect():
    rng = np.random.default_rng(9)
    p = SketchParams(scaled=50, hv_d=HV_D)
    rep = _width_repeat(rng, p, 60_000)
    normal = _codes(rng, 50_000)
    sk = _port(p, batch=1)
    assert sk._bucket(rep.size) == 32 and sk._enc_cap(32) < rep.size // 16
    handles = [sk.submit_batch([normal]), sk.submit_batch([rep])]
    got = sk.collect_batches(handles[::-1])[::-1]
    assert sk.retries == {"width": 1}
    jx = _jax(p, batch=1)
    _assert_same(_flat(got), [jx.sketch_codes(normal), jx.sketch_codes(rep)])
    # the bucket keeps its grown width: the next repeat does not overflow
    sk.collect(sk.submit(rep))
    assert sk.retries == {"width": 1}


def test_retry_limit_raises():
    rng = np.random.default_rng(10)
    p = SketchParams(scaled=50, hv_d=HV_D)
    sk = _port(p, batch=1)
    handle = sk.submit(_width_repeat(rng, p, 60_000))
    sk._enc_cap = lambda n_chunks: 256  # a width that never grows
    with pytest.raises(RuntimeError, match="retry limit"):
        sk.collect(handle)
    assert sk.retries["width"] == 7


# -- sketch_files(pipeline_depth) ---------------------------------------------

def _write(path, codes):
    seq = np.frombuffer(b"ACGT", np.uint8)[np.where(codes < 4, codes, 0)]
    seq[codes >= 4] = ord("N")
    path.write_bytes(b">g one\n" + seq.tobytes() + b"\n")
    return path


def _folder(d, rng, lengths):
    d.mkdir()
    return [_write(d / f"g{i}.fna", _codes(rng, bp))
            for i, bp in enumerate(lengths)]


@pytest.fixture(scope="module")
def depth_folder(tmp_path_factory):
    """Three buckets, full and partial batches at batch=2, and the JAX
    package's .sketch of them at pipeline_depth=2."""
    d = tmp_path_factory.mktemp("depth")
    rng = np.random.default_rng(61)
    paths = _folder(d / "g", rng, [3000, 12_000, 3500, 14_000, 2500, 3100,
                                   13_000, 40, 2900])
    p = SketchParams(hv_d=HV_D, scaled=40)
    jdb.dump_sketch(_jax(p, batch=2).sketch_files(
        paths, progress=False, pipeline_depth=2), d / "j.sketch")
    return p, paths, (d / "j.sketch").read_bytes()


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_sketch_files_depth_matches_jax(tmp_path, depth_folder, depth):
    """The window full and drained: the .sketch bytes of every depth equal
    the JAX package's sketch_files(pipeline_depth=2)."""
    p, paths, want = depth_folder
    tdb.dump_sketch(_port(p, batch=2).sketch_files(
        paths, progress=False, pipeline_depth=depth), tmp_path / "t.sketch")
    assert (tmp_path / "t.sketch").read_bytes() == want


def test_sketch_files_window_bound_and_huge_drain(tmp_path, monkeypatch):
    """At most pipeline_depth handles are uncollected after a submit, the
    window is empty when a huge genome starts, and the bytes equal those
    of depth 1."""
    rng = np.random.default_rng(62)
    paths = _folder(tmp_path / "g", rng, [3000, 3200, 2800, 40_000, 3100,
                                          2700, 2600, 3300])
    p = SketchParams(hv_d=HV_D, scaled=40)
    out = {}
    for depth in (1, 3):
        sk = _port(p, batch=1, seqpar_min_chunks=16)
        live, peak, at_huge = set(), [0], []
        submit, collect, huge = (sk.submit_batch_packed, sk.collect_batch,
                                 sk._sketch_huge)

        def spy_submit(genomes):
            h = submit(genomes)
            live.add(id(h))
            peak[0] = max(peak[0], len(live))
            return h

        def spy_collect(h):
            live.discard(id(h))
            return collect(h)

        def spy_huge(g):
            at_huge.append(len(live))
            return huge(g)

        monkeypatch.setattr(sk, "submit_batch_packed", spy_submit)
        monkeypatch.setattr(sk, "collect_batch", spy_collect)
        monkeypatch.setattr(sk, "_sketch_huge", spy_huge)
        tdb.dump_sketch(sk.sketch_files(paths, progress=False,
                                        pipeline_depth=depth),
                        tmp_path / f"d{depth}.sketch")
        out[depth] = (tmp_path / f"d{depth}.sketch").read_bytes()
        assert peak[0] == depth and at_huge == [0] and not live
        assert {"collect", "huge_tiled"} <= set(sk.last_stage_times)
        # the step's parts are spans apart from the stages
        assert not set(ts.STEP_PARTS) & set(sk.last_stage_times)
    assert out[1] == out[3]
