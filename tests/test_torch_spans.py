"""The port's spans (``utils.timing.span``) on the CPU.

Without a profiler a span enters no profiler range and its totals still
advance; while one records, the sketch path (``sketch_files``, and
``submit_batch_packed``/``collect_batch`` called directly), the ``.hgdb``
write and load and every search route put their ``hg:`` ranges in the
trace, nested as called, and so does `dist`'s pair path, whose counters
(``COUNTERS``) count the fetched and the kept pairs. The
span totals over a ``sketch_files`` call equal its ``last_stage_times``.
The benchmark's readers of the span totals and counters
(``portbench/metrics``) are held to hand-built runs, and report nothing
where the program keeps no span totals or counters.
"""

import argparse

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from hypergen_tpu_torch.cli import run_dist
from hypergen_tpu_torch.io import sketch_db as tdb
from hypergen_tpu_torch.io.fastx import packed_from_codes
from hypergen_tpu_torch.models.comparator import Comparator, write_ani_report
from hypergen_tpu_torch.models.sketcher import STEP_PARTS, Sketcher
from hypergen_tpu_torch.parallel import search as tsearch
from hypergen_tpu_torch.params import SketchParams
from hypergen_tpu_torch.utils import timing as ttiming
from hypergen_tpu_torch.utils.timing import COUNTERS, SPANS, span
from portbench.harness import program_counters, program_spans
from portbench.harness import spec as bench_spec
from portbench.harness.runner import RunData

STAGES = ("io_pool", "fasta_read", "pack", "dispatch", "collect", "compress")
SEARCH = ("search_mode_scan", "search_upload", "search_dot_topk",
          "search_fetch", "search_host_chain")
LOAD = ("db_load_manifest", "db_load_assemble", "db_load_read")
DIST = ("dist_compare", "dist_preload", "dist_fetch", "dist_host_chain",
        "dist_finish", "dist_report")
DIST_COUNTERS = ("dist_candidates", "dist_kept")


def _profiled(fn):
    """fn() inside a CPU profile and the range "test:call"; (result, the
    hg: events as (name, the innermost hg: or test: range around it))."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test:call"):
            out = fn()
    ranges = []
    for e in prof.events():
        if not e.name.startswith("hg:"):
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith(("hg:", "test:")):
            p = p.cpu_parent
        ranges.append((e.name, p.name if p is not None else None))
    return out, ranges


def _names(ranges):
    return {n for n, _ in ranges}


def _parents(ranges, name):
    return {p for n, p in ranges if n == name}


def _genomes(d, n=5, bp=12_000, seed=41):
    rng = np.random.default_rng(seed)
    d.mkdir()
    for i in range(n):
        seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=bp)]
        seq[300 + i : 500] = ord("N")
        (d / f"g{i}.fna").write_bytes(b">g\n" + seq.tobytes() + b"\n")
    return sorted(d.iterdir())


def _sketcher():
    return Sketcher(SketchParams(hv_d=256, scaled=40), device="cpu",
                    chunk_positions=2048, batch=2)


def test_span_totals_advance_without_a_profiler(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a profiler range entered with no profiler")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    before = SPANS["t_quiet"].n, SPANS["t_quiet"].ns
    assert not torch.autograd._profiler_enabled()
    for _ in range(3):
        with span("t_quiet") as sp:
            sum(range(1000))
        assert sp.ns > 0
    t = SPANS.t_quiet
    assert (t.n, int(t.ns) > before[1]) == (before[0] + 3, True)
    assert t.cpu_ns == 0  # the thread's CPU clock is read on request only
    with span("t_busy", cpu=True):
        sum(range(300_000))
    assert 0 < SPANS.t_busy.cpu_ns <= 2 * SPANS.t_busy.ns
    assert int(SPANS.t_never_opened.ns) == SPANS["t_never_opened"].n == 0


def test_sketch_step_needs_no_profiler_range(tmp_path, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a profiler range entered with no profiler")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    names = STAGES + STEP_PARTS
    before = SPANS.snapshot(names)
    _sketcher().sketch_files(_genomes(tmp_path / "g"), progress=False)
    assert all(SPANS[k].n > n for k, (_, n) in before.items())


def test_span_range_carries_its_argument(monkeypatch):
    """The range's one argument is the span's name, as ``hg:<name>``."""
    seen = []
    real = torch._C._profiler._RecordFunctionFast

    def spy(*a, **kw):
        seen.append((a, kw))
        return real(*a, **kw)

    def one():
        with span("t_arg"):
            pass

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", spy)
    _, ranges = _profiled(one)
    assert seen == [(("hg:t_arg",), {})]
    assert ranges == [("hg:t_arg", "test:call")]


def test_span_clocks_cover_its_range(monkeypatch):
    """Entering and leaving the profiler range fall inside the span's wall
    and CPU time, so that stages which tile a thread's time still add up
    to its wall while a profiler records."""
    import time

    now = [0]
    real = torch._C._profiler._RecordFunctionFast

    class Slow:  # entering and leaving each take 1,000 ns on both clocks
        def __init__(self, *a):
            self.rf = real(*a)

        def __enter__(self):
            now[0] += 1000
            return self.rf.__enter__()

        def __exit__(self, *exc):
            self.rf.__exit__(*exc)
            now[0] += 1000

    def one():
        with span("t_cover", cpu=True) as sp:
            pass
        return sp

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Slow)
    monkeypatch.setattr(time, "perf_counter_ns", lambda: now[0])
    monkeypatch.setattr(time, "thread_time_ns", lambda: now[0])
    before = SPANS.t_cover.cpu_ns
    sp, ranges = _profiled(one)
    assert ranges == [("hg:t_cover", "test:call")]
    assert sp.ns == 2000
    assert SPANS.t_cover.cpu_ns - before == 2000


def test_sketch_files_ranges_nest_as_called(tmp_path):
    sk = _sketcher()
    paths = _genomes(tmp_path / "g")
    _, ranges = _profiled(lambda: sk.sketch_files(paths, progress=False))
    assert _names(ranges) == {f"hg:{n}" for n in STAGES + STEP_PARTS}
    for n in STAGES:
        assert _parents(ranges, f"hg:{n}") == {"test:call"}, n
    for n in STEP_PARTS:  # enqueued by dispatch, or by a rerun at collect
        assert "hg:dispatch" in _parents(ranges, f"hg:{n}") <= {
            "hg:dispatch", "hg:collect"}, n
    # 5 genomes in batches of 2: dispatch and collect once a batch
    for n in ("hg:dispatch", "hg:collect"):
        assert sum(m == n for m, _ in ranges) == 3, n


def test_submit_and_collect_ranges_outside_sketch_files():
    sk = _sketcher()
    rng = np.random.default_rng(42)
    genomes = [packed_from_codes(rng.integers(0, 4, 9_000).astype(np.uint8))
               for _ in range(2)]
    before = SPANS.snapshot(("pack", "dispatch", "collect") + STEP_PARTS)

    def call():
        return sk.collect_batch(sk.submit_batch_packed(genomes))

    res, ranges = _profiled(call)
    assert len(res) == 2
    assert _names(ranges) == {"hg:pack", "hg:dispatch", "hg:collect"} | {
        f"hg:{n}" for n in STEP_PARTS}
    for n in ("pack", "dispatch", "collect"):
        assert _parents(ranges, f"hg:{n}") == {"test:call"}
    for n in STEP_PARTS:
        assert _parents(ranges, f"hg:{n}") == {"hg:dispatch"}
    assert all(SPANS[k].n == n + 1 for k, (_, n) in before.items())
    assert sk.last_stage_times == {}  # no stage table outside sketch_files


def test_span_totals_equal_last_stage_times(tmp_path):
    sk = _sketcher()
    paths = _genomes(tmp_path / "g")
    before = SPANS.snapshot(STAGES + STEP_PARTS)
    sk.sketch_files(paths, progress=False)
    assert set(sk.last_stage_times) == set(STAGES)
    assert set(sk.last_part_times) == set(STEP_PARTS)
    times = {**sk.last_stage_times, **sk.last_part_times}
    for k, (ns, _) in before.items():
        assert times[k] == pytest.approx(
            (SPANS[k].ns - ns) / 1e9, rel=1e-9, abs=1e-9), k


def _db(rng, n, d=256, names="r"):
    hv = rng.integers(-60, 61, size=(n, d)).astype(np.int16)
    norms = (hv.astype(np.int64) ** 2).sum(1).astype(np.int32)
    return tdb.ShardedDB(ksize=21, scaled=1500, canonical=True, seed=123,
                         hv_d=d, names=[f"{names}{i}" for i in range(n)],
                         hvs=hv, norms=norms)


def test_hgdb_write_and_load_ranges(tmp_path):
    sk = _sketcher()
    sketches = sk.sketch_files(_genomes(tmp_path / "g"), progress=False)
    out = tmp_path / "db.hgdb"

    def write():
        tdb.dump_sharded_db(tdb.sketches_to_db(sketches), out, n_shards=2)

    _, ranges = _profiled(write)
    assert ranges == [("hg:db_decompress", "test:call"),
                      ("hg:db_save", "test:call")]
    db, ranges = _profiled(lambda: tdb.load_sharded_db(out))
    assert ranges == [(f"hg:{n}", "test:call") for n in LOAD]
    np.testing.assert_array_equal(
        db.hvs, np.stack([s.decompress() for s in sketches]))
    assert db.names == [s.file_str for s in sketches]


# parts: a tile's share on one device, each deciding its mode in a span
@pytest.mark.parametrize("devices,limit,parts", [
    (["cpu"], None, 1),  # one pass
    (["cpu", "cpu"], None, 2),  # sharded
    (["cpu"], 64 * 24, 3),  # tiles of 256 rows
    (["cpu", "cpu"], 64 * 24, 4),  # tiles of 2 x 256 rows
], ids=["one_pass", "sharded", "tiled", "sharded_tiled"])
def test_search_ranges_on_every_route(tmp_path, monkeypatch, devices, limit,
                                      parts):
    rng = np.random.default_rng(43)
    ref, q = _db(rng, 600), _db(rng, 24, names="q")
    q.hvs[:8] = ref.hvs[:8]
    q.norms[:8] = ref.norms[:8]
    tdb.dump_sharded_db(ref, tmp_path / "r.hgdb", n_shards=3)
    tdb.dump_sharded_db(q, tmp_path / "q.hgdb")
    args = argparse.Namespace(path_r=tmp_path / "r.hgdb",
                              path_q=tmp_path / "q.hgdb", out=None, top_k=5,
                              ani_th=0.0)

    def load(path):
        with record_function("test:load"):
            return tdb.load_sharded_db(path)

    def call(out, devices):
        args.out = out
        tsearch.run_search_cli(args, load, devices)

    call(tmp_path / "want.tsv", ["cpu"])
    if limit is not None:
        monkeypatch.setattr(tsearch, "PAIRS_PER_DEVICE_TILE_LIMIT", limit)
    before = SPANS.snapshot(SEARCH)
    _, ranges = _profiled(lambda: call(tmp_path / "got.tsv", devices))
    assert _names(ranges) == {f"hg:{n}" for n in SEARCH + LOAD}
    for n in SEARCH:
        assert _parents(ranges, f"hg:{n}") == {"test:call"}, n
        assert SPANS[n].n > before[n][1], n
    for n in LOAD:
        assert _parents(ranges, f"hg:{n}") == {"test:load"}, n
    # once for the queries and once a part
    assert (SPANS.search_mode_scan.n
            == before["search_mode_scan"][1] + 1 + parts)
    assert SPANS.search_host_chain.n == before["search_host_chain"][1] + 1
    assert ((tmp_path / "got.tsv").read_bytes()
            == (tmp_path / "want.tsv").read_bytes())


def _collection(tmp_path, n=300):
    """An .hgdb of n random rows, row 1 a copy of row 0 (a pair at 100)."""
    db = _db(np.random.default_rng(44), n)
    db.hvs[1] = db.hvs[0]
    db.norms[1] = db.norms[0]
    tdb.dump_sharded_db(db, tmp_path / "c.hgdb", n_shards=2)
    return db, tmp_path / "c.hgdb"


def _dist_args(path, out, threshold):
    return argparse.Namespace(path_r=path, path_q=path, out=out, ksize=21,
                              hv_d=256, ani_th=threshold, device="cpu")


def _counters():
    return {k: getattr(COUNTERS, k) for k in DIST_COUNTERS}


@pytest.mark.parametrize("threshold", [95.0, 40.0],
                         ids=["thresholded", "streamed"])
def test_dist_ranges_nest_as_called(tmp_path, threshold):
    _, path = _collection(tmp_path)
    out = tmp_path / "d.tsv"
    before, counted = SPANS.snapshot(DIST), _counters()
    _, ranges = _profiled(lambda: run_dist(_dist_args(path, out, threshold)))
    assert _names(ranges) == {f"hg:{n}" for n in DIST + LOAD}
    for n in ("dist_compare", "dist_report"):
        assert _parents(ranges, f"hg:{n}") == {"test:call"}, n
    for n in ("dist_preload", "dist_fetch", "dist_host_chain", "dist_finish"):
        assert _parents(ranges, f"hg:{n}") == {"hg:dist_compare"}, n
    assert all(SPANS[k].n > n for k, (_, n) in before.items())
    # no top-k cap: the pairs kept are the report's rows
    lines = out.read_text().count("\n")
    assert lines >= 1
    assert COUNTERS.dist_kept - counted["dist_kept"] == lines


def test_dist_needs_no_profiler_range(tmp_path, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a profiler range entered with no profiler")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    _, path = _collection(tmp_path)
    before, counted = SPANS.snapshot(DIST), _counters()
    run_dist(_dist_args(path, tmp_path / "d.tsv", 95.0))
    assert all(SPANS[k].n > n for k, (_, n) in before.items())
    assert COUNTERS.dist_candidates > counted["dist_candidates"]


@pytest.mark.parametrize("path", ["thresholded", "streamed"])
def test_dist_counters_count_the_tile_grid(tmp_path, path):
    """300 rows in tiles of 128: a 3 x 3 grid, of which the 6 tiles on or
    above the diagonal are computed and fetched, one dist_fetch each."""
    db, _ = _collection(tmp_path)
    comp = Comparator(ksize=21, device="cpu", tile_m=128, tile_n=128)
    threshold = 95.0 if path == "thresholded" else 40.0
    fetched, counted = SPANS.dist_fetch.n, _counters()
    ri, qi, ani, _ = getattr(comp, f"ani_pairs_{path}")(
        db, db, symmetric=True, threshold=threshold)
    out = tmp_path / "d.tsv"
    n = write_ani_report(out, db.names, db.names, ri, qi, ani, threshold)
    got = {k: getattr(COUNTERS, k) - v for k, v in counted.items()}
    assert SPANS.dist_fetch.n - fetched == 6
    assert got["dist_kept"] == n == out.read_text().count("\n") >= 1
    if path == "streamed":  # every pair of a computed tile
        assert got["dist_candidates"] == 3 * 128 * 128 + 2 * 128 * 44 + 44 * 44
    else:
        assert got["dist_kept"] <= got["dist_candidates"] < 128 * 128


# -- the benchmark's readers of the span totals -----------------------------

def _run(counters, calls=4):
    return RunData(cell={}, config={}, mix={}, n_devices=1, setup_s=1.0,
                   window_s=50.0, calls=calls, work={}, stages={}, span_s={},
                   span_n={}, counters=counters, needed={}, trace=None,
                   unmatched=set())


@pytest.mark.parametrize("metric,counters,want", [
    ("search.load_read_share", {"db_load_manifest.ns": 100,
                                "db_load_read.ns": 600,
                                "db_load_assemble.ns": 300}, 60.0),
    ("search.mode_scan_ms_per_call", {"search_mode_scan.ns": 720_000_000,
                                      "search_mode_scan.n": 4}, 180.0),
    ("search.host_chain_ms_per_call", {"search_host_chain.ns": 200_000_000,
                                       "search_host_chain.n": 4}, 50.0),
    ("sketch.host_offcpu_share", {"pack.ns": 3000, "pack.cpu_ns": 1000,
                                  "dispatch.ns": 1000,
                                  "dispatch.cpu_ns": 1000}, 50.0),
    ("sketch.db_decompress_ms_per_call", {"db_decompress.ns": 1_600_000_000,
                                          "db_decompress.n": 4}, 400.0),
    ("dist.us_per_tile", {"dist_compare.ns": 8_000_000, "dist_fetch.n": 4},
     2000.0),
    ("dist.host_chain_ms_per_call", {"dist_host_chain.ns": 40_000_000,
                                     "dist_host_chain.n": 8}, 10.0),
    ("dist.report_ms_per_call", {"dist_finish.ns": 100_000_000,
                                 "dist_finish.n": 4,
                                 "dist_report.ns": 300_000_000,
                                 "dist_report.n": 4}, 100.0),
    ("dist.candidates_per_kept", {"dist_candidates": 1100,
                                  "dist_kept": 1000}, 1.1),
])
def test_span_metric_readers(metric, counters, want):
    reader = bench_spec.reader(metric)
    assert set(reader.COUNTERS) == set(counters)
    # each reference reaches the program's totals
    for ref in reader.COUNTERS.values():
        assert isinstance(bench_spec.counter_value(ref), int)
    assert reader.read(_run(counters)) == pytest.approx(want)
    # nothing to read: a program without the spans, or a window without them
    assert reader.read(_run({})) is None
    assert reader.read(_run(dict.fromkeys(counters, 0))) is None


def test_span_refs_need_the_programs_totals(monkeypatch):
    assert program_spans.refs(["pack"], ("ns", "cpu_ns")) == {
        "pack.ns": "hypergen_tpu_torch.utils.timing:SPANS.pack.ns",
        "pack.cpu_ns": "hypergen_tpu_torch.utils.timing:SPANS.pack.cpu_ns"}
    monkeypatch.delattr(ttiming, "SPANS")
    assert program_spans.refs(["pack"]) == {}


def test_counter_refs_need_the_programs_counters(monkeypatch):
    assert program_counters.refs(["dist_kept"]) == {
        "dist_kept": "hypergen_tpu_torch.utils.timing:COUNTERS.dist_kept"}
    assert bench_spec.counter_value(
        "hypergen_tpu_torch.utils.timing:COUNTERS.t_never_counted") == 0
    monkeypatch.delattr(ttiming, "COUNTERS")
    assert program_counters.refs(["dist_kept"]) == {}
