"""The port's TSV rows from the native formatter (``csrc/tsv_rows.cpp``)
against Python's own formatting and the JAX package's writers.

The routine's ANI bytes equal ``f"{x:.3f}"`` on every float32 in [95, 100],
on seeded values in [0, 100] and at the ties and width edges; whole
`dist` and `search` reports equal ``format_ani_report`` and the JAX
package's writers, bytes and counts; and the np.char path takes over,
with the same bytes and counted in ``tsv_rows_fallback``, where the
library cannot be loaded or a chunk holds a value it cannot print.
"""

import locale

import numpy as np
import pytest

from hypergen_tpu.models import comparator as jax_comp
from hypergen_tpu_torch.models import comparator as torch_comp
from hypergen_tpu_torch.ops.kernels import build
from hypergen_tpu_torch.utils.timing import COUNTERS

ENC = locale.getpreferredencoding(False)


def _f32_range(lo, hi):
    """Every float32 in [lo, hi] (lo, hi >= 0: the bits count up)."""
    a, b = np.array([lo, hi], np.float32).view(np.uint32)
    return np.arange(a, b + 1, dtype=np.uint32).view(np.float32)


def _edges():
    f = np.float32
    near = [f(9.9995), f(99.9995), f(999.9995), f(1000.0)]
    return np.array(
        [0.0, 100.0, 97.0625, 0.0625, 0.1875, 2.5625, 99.9375, 1e-45, 0.0005,
         0.0015]
        + [np.nextafter(x, f(0)) for x in near]
        + [x for x in near[:3]]
        + [np.nextafter(x, f(2000)) for x in near[:3]],
        np.float32)


VALUES = {
    "every_f32_95_100": lambda: _f32_range(95.0, 100.0),
    "seeded_0_100": lambda: np.random.default_rng(19).uniform(
        0, 100, 100_000).astype(np.float32),
    "edges": _edges,
}


@pytest.mark.parametrize("case", sorted(VALUES))
def test_value_bytes_equal_python_format(case):
    """The routine's rows `\\t\\t<ANI>\\n` (two empty names) against
    Python's '%.3f' of each float32's value, ties to even included."""
    vals = VALUES[case]()
    if case == "every_f32_95_100":
        assert vals.size == 655_361
    lib = torch_comp._tsv_lib()
    assert lib is not None, "the native TSV formatter did not build"
    names = torch_comp._encode_names([""], ENC)
    zeros = np.zeros(vals.size, np.int64)
    got = torch_comp._native_rows(lib, names, names, zeros, zeros, vals)
    want = "".join(f"\t\t{x:.3f}\n" for x in vals.tolist()).encode()
    assert got.tobytes() == want


NAMES = {
    "symmetric": lambda: ([f"g{i}.fna" for i in range(64)],) * 2,
    "asymmetric": lambda: ([f"r{i}.fna" for i in range(40)],
                           [f"query_{i:04d}.fa.gz" for i in range(64)]),
    # non-ASCII names of different lengths and byte widths
    "non_ascii": lambda: (
        [f"Escherichia_coli_é{i}" + "ß" * (i % 5) for i in range(40)],
        [f"クエリ{i}" + "x" * (i % 7) + "_ü.fna" for i in range(64)]),
}


def _pairs(rng, names_r, names_q, n=3000):
    ri = rng.integers(0, len(names_r), size=n)
    qi = rng.integers(0, len(names_q), size=n)
    # quantized values force ties; a run straddles the threshold
    ani = (rng.integers(0, 41, size=n) * 2.5).astype(np.float32)
    ani[::97] = np.float32(97.0625)
    return ri, qi, ani


def _search_ani(rng, n_q, k):
    ani = rng.choice(np.array([100.0, 99.5, 97.0625, 85.0, 80.0, np.nan],
                              np.float32), size=(n_q, k))
    return ani


@pytest.mark.parametrize("threshold", [0.0, 85.0, 101.0])
@pytest.mark.parametrize("top_k", [0, 7])
@pytest.mark.parametrize("names", sorted(NAMES) + ["empty"])
def test_reports_equal_format_and_jax(tmp_path, names, top_k, threshold):
    """write_ani_report (chunks of 257 rows) and write_search_report
    (chunks of 5 queries) through the native formatter: the bytes of
    format_ani_report and of the JAX package's writers, every row counted
    in tsv_rows_native."""
    rng = np.random.default_rng(23)
    if names == "empty":
        ref_names, q_names = [], []
        ri = qi = np.zeros(0, np.int64)
        ani = np.zeros(0, np.float32)
        s_idx, s_ani = np.zeros((0, 4), np.int64), np.zeros((0, 4), np.float32)
    else:
        ref_names, q_names = NAMES[names]()
        ri, qi, ani = _pairs(rng, ref_names, q_names)
        s_idx = rng.integers(0, len(ref_names), size=(len(q_names), 4))
        s_ani = _search_ani(rng, len(q_names), 4)
    n0, f0 = COUNTERS.tsv_rows_native, COUNTERS.tsv_rows_fallback

    want, n_want = torch_comp.format_ani_report(
        ref_names, q_names, ri, qi, ani, threshold, top_k=top_k)
    n = torch_comp.write_ani_report(tmp_path / "t.tsv", ref_names, q_names,
                                    ri, qi, ani, threshold, top_k=top_k,
                                    chunk_rows=257)
    jax_comp.write_ani_report(tmp_path / "j.tsv", ref_names, q_names, ri, qi,
                              ani, threshold, top_k=top_k)
    got = (tmp_path / "t.tsv").read_bytes()
    assert n == n_want
    assert got == want.encode(ENC) == (tmp_path / "j.tsv").read_bytes()

    n_s = torch_comp.write_search_report(tmp_path / "ts.tsv", ref_names,
                                         q_names, s_idx, s_ani, threshold,
                                         chunk_queries=5)
    n_js = jax_comp.write_search_report(tmp_path / "js.tsv", ref_names,
                                        q_names, s_idx, s_ani, threshold)
    assert n_s == n_js == torch_comp.count_search_hits(s_ani, threshold)
    assert ((tmp_path / "ts.tsv").read_bytes()
            == (tmp_path / "js.tsv").read_bytes())
    assert COUNTERS.tsv_rows_native - n0 == n + n_s
    assert COUNTERS.tsv_rows_fallback == f0


@pytest.fixture
def fresh_lib():
    """_tsv_lib's cached answer dropped before and after the test."""
    torch_comp._tsv_lib.cache_clear()
    yield
    torch_comp._tsv_lib.cache_clear()


def test_load_failure_takes_numpy_path(tmp_path, monkeypatch, fresh_lib):
    """With the library's load failing, both writers write the same bytes
    through np.char, every row counted in tsv_rows_fallback."""
    def fail(name):
        raise OSError(f"cannot load {name}")

    monkeypatch.setattr(build, "load", fail)
    ref_names, q_names = NAMES["non_ascii"]()
    rng = np.random.default_rng(29)
    ri, qi, ani = _pairs(rng, ref_names, q_names)
    s_idx = rng.integers(0, len(ref_names), size=(len(q_names), 4))
    s_ani = _search_ani(rng, len(q_names), 4)
    n0, f0 = COUNTERS.tsv_rows_native, COUNTERS.tsv_rows_fallback

    want, n_want = torch_comp.format_ani_report(ref_names, q_names, ri, qi,
                                                ani, 85.0)
    n = torch_comp.write_ani_report(tmp_path / "t.tsv", ref_names, q_names,
                                    ri, qi, ani, 85.0, chunk_rows=257)
    assert torch_comp._tsv_lib() is None
    assert n == n_want
    assert (tmp_path / "t.tsv").read_bytes() == want.encode(ENC)
    n_s = torch_comp.write_search_report(tmp_path / "ts.tsv", ref_names,
                                         q_names, s_idx, s_ani, 85.0,
                                         chunk_queries=5)
    jax_comp.write_search_report(tmp_path / "js.tsv", ref_names, q_names,
                                 s_idx, s_ani, 85.0)
    assert ((tmp_path / "ts.tsv").read_bytes()
            == (tmp_path / "js.tsv").read_bytes())
    assert COUNTERS.tsv_rows_fallback - f0 == n + n_s
    assert COUNTERS.tsv_rows_native == n0


@pytest.mark.parametrize("bad", [np.inf, 1000.0, 1e30, -0.0])
def test_unprintable_value_takes_numpy_path_for_its_chunk(tmp_path, bad):
    """One value the routine refuses (not finite, 1000 or more, -0.0):
    its chunk of rows, and only that chunk, goes through np.char, and the
    bytes equal format_ani_report's."""
    ref_names, q_names = NAMES["asymmetric"]()
    rng = np.random.default_rng(31)
    ri, qi, ani = _pairs(rng, ref_names, q_names)
    ani[1234] = np.float32(bad)
    chunk, thr = 257, 0.0
    kept = np.flatnonzero(ani >= np.float32(thr))
    order = kept[np.argsort(ani[kept], kind="stable")[::-1]]
    first = int(np.flatnonzero(order == 1234)[0]) // chunk * chunk
    n_chunk = min(chunk, order.size - first)
    n0, f0 = COUNTERS.tsv_rows_native, COUNTERS.tsv_rows_fallback

    want, n_want = torch_comp.format_ani_report(ref_names, q_names, ri, qi,
                                                ani, thr)
    n = torch_comp.write_ani_report(tmp_path / "t.tsv", ref_names, q_names,
                                    ri, qi, ani, thr, chunk_rows=chunk)
    assert n == n_want
    assert (tmp_path / "t.tsv").read_bytes() == want.encode(ENC)
    assert COUNTERS.tsv_rows_fallback - f0 == n_chunk
    assert COUNTERS.tsv_rows_native - n0 == n - n_chunk


def test_unencodable_unused_name_keeps_numpy_bytes(tmp_path):
    """A name the file's codec cannot encode, in no row: the names cannot
    be encoded up front, so the report takes the np.char path, which
    writes it as before (the rows never use it)."""
    ref_names = [f"r{i}" for i in range(8)] + ["bad\udcff"]
    q_names = [f"q{i}" for i in range(8)]
    rng = np.random.default_rng(37)
    ri, qi = rng.integers(0, 8, 50), rng.integers(0, 8, 50)
    ani = rng.uniform(80, 100, 50).astype(np.float32)
    f0 = COUNTERS.tsv_rows_fallback
    want, n_want = torch_comp.format_ani_report(ref_names, q_names, ri, qi,
                                                ani, 85.0)
    n = torch_comp.write_ani_report(tmp_path / "t.tsv", ref_names, q_names,
                                    ri, qi, ani, 85.0)
    assert n == n_want
    assert (tmp_path / "t.tsv").read_bytes() == want.encode(ENC)
    assert COUNTERS.tsv_rows_fallback - f0 == n
