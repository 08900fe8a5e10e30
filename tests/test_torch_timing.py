"""Stage timing and profiler traces of the port, against the JAX package.

``hypergen_tpu_torch.utils.timing.StageTimer`` is the JAX package's class:
the same spans on the same clock give the same totals, counts and report
text (tolerance 0). ``SketchTimer`` charges a nested span to itself only
and keeps the step's parts out of its stages, on the CPU as on a card.
``HG_TRACE_DIR`` wraps a CLI command in a ``torch.profiler`` trace, and
``HG_STAGE_TIMING`` logs ``Sketcher.sketch_files``' stage table without
changing a byte of the ``.sketch``.
"""

import json
import logging
import time

import numpy as np
import pytest

from hypergen_tpu.utils import timing as jtiming
from hypergen_tpu_torch import utils as tutils
from hypergen_tpu_torch.cli import main
from hypergen_tpu_torch.models.sketcher import STEP_PARTS, Sketcher
from hypergen_tpu_torch.params import SketchParams
from hypergen_tpu_torch.utils import timing as ttiming

# the sketch step's stages on a folder of small genomes (one batch route);
# the step's parts (sketcher.STEP_PARTS) run inside dispatch, apart
BATCH_STAGES = {"io_pool", "fasta_read", "pack", "dispatch", "collect",
                "compress"}


class _Clock:
    """time.monotonic stand-in: each call advances by the next step."""

    def __init__(self, steps):
        self.t, self.steps = 100.0, list(steps)

    def __call__(self):
        self.t += self.steps.pop(0)
        return self.t


# (span name, seconds inside it): the clock is read at entry and exit
SPANS = [("collect", 0.5), ("fasta_read", 0.125), ("collect", 1.25),
         ("compress", 0.0), ("fasta_read", 2.0), ("zeta", 0.5)]


def _run(timer_cls, monkeypatch):
    steps = [x for _, dt in SPANS for x in (0.25, dt)]
    monkeypatch.setattr(time, "monotonic", _Clock(steps))
    timer = timer_cls()
    for name, _ in SPANS:
        with timer.stage(name):
            pass
    monkeypatch.undo()
    return timer


def test_stage_timer_matches_jax(monkeypatch):
    got = _run(ttiming.StageTimer, monkeypatch)
    want = _run(jtiming.StageTimer, monkeypatch)
    assert dict(got.totals) == dict(want.totals)
    assert dict(got.counts) == dict(want.counts)
    assert got.report() == want.report()
    assert got.report().splitlines()[0] == "fasta_read: 2.125s over 2 calls"
    assert tutils.StageTimer is ttiming.StageTimer


def test_stage_timer_empty_report_matches_jax():
    assert ttiming.StageTimer().report() == jtiming.StageTimer().report() == ""


def test_sketch_timer_charges_nested_spans_once(monkeypatch):
    # the outer stage opens at 101 s and closes at 111.5 s; inside it,
    # dispatch runs 102 -> 105 and 110 -> 110.5 (the spans' clock, in ns);
    # the step's part inside the first dispatch (103 -> 104) is a span of
    # its own, outside the stages' tiling
    ns = _Clock([1, 1, 1, 1, 1, 5, 0.5, 1])
    monkeypatch.setattr(time, "perf_counter_ns", lambda: round(ns() * 1e9))
    timer = ttiming.SketchTimer(("encode",))
    with timer.stage("huge_tiled"):
        with timer.stage("dispatch"):
            with ttiming.span("encode"):
                pass
        with timer.stage("dispatch"):
            pass
    monkeypatch.undo()
    timer.resolve()
    assert dict(timer.totals) == {"huge_tiled": 7.0, "dispatch": 3.5}
    assert dict(timer.counts) == {"huge_tiled": 1, "dispatch": 2}
    assert timer.part_totals == {"encode": 1.0}
    assert timer.part_counts == {"encode": 1}


def test_maybe_profile_off_is_a_no_op(tmp_path):
    with ttiming.maybe_profile(""):
        pass
    with ttiming.maybe_profile():
        pass
    assert list(tmp_path.iterdir()) == []


def test_maybe_profile_writes_a_cpu_trace(tmp_path):
    import torch

    out = tmp_path / "trace"
    with ttiming.maybe_profile(str(out)):
        torch.arange(1000).sum()
    (f,) = out.iterdir()
    assert f.name.startswith("hypergen_") and f.name.endswith("_p0.json")
    assert json.loads(f.read_text())["traceEvents"]


def _genomes(d, n=3, bp=20_000):
    rng = np.random.default_rng(31)
    d.mkdir()
    for i in range(n):
        seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=bp)]
        seq[500 + i : 700] = ord("N")
        (d / f"g{i}.fna").write_bytes(b">g\n" + seq.tobytes() + b"\n")
    return d


def test_cli_trace_dir_writes_a_trace(tmp_path, monkeypatch):
    g = _genomes(tmp_path / "g")
    monkeypatch.setenv("HG_TRACE_DIR", str(tmp_path / "tr"))
    main(["sketch", "-p", str(g), "-o", str(tmp_path / "a.sketch"), "-D",
          "cpu", "-d", "256", "-s", "40"])
    (f,) = (tmp_path / "tr").iterdir()
    names = {e.get("name") for e in json.loads(f.read_text())["traceEvents"]}
    assert any(str(n).startswith("aten::") for n in names)


def test_stage_timing_logs_the_table_and_keeps_bytes(tmp_path, monkeypatch,
                                                     caplog):
    g = _genomes(tmp_path / "g")
    argv = ["sketch", "-p", str(g), "-D", "cpu", "-d", "256", "-s", "40"]
    monkeypatch.delenv("HG_STAGE_TIMING", raising=False)
    main(argv + ["-o", str(tmp_path / "off.sketch")])
    monkeypatch.setenv("HG_STAGE_TIMING", "1")
    logger = logging.getLogger("hypergen")  # the CLI stops propagation
    logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.INFO, logger="hypergen"):
            main(argv + ["-o", str(tmp_path / "on.sketch")])
    finally:
        logger.removeHandler(caplog.handler)
    (msg,) = [r.getMessage() for r in caplog.records
              if r.getMessage().startswith("sketch stage timing:")]
    head = "step parts (the host's enqueue, inside dispatch):"
    lines = msg.splitlines()[1:]
    cut = lines.index(head)
    assert {ln.split(":")[0] for ln in lines[:cut]} == BATCH_STAGES
    assert {ln.split(":")[0] for ln in lines[cut + 1:]} == set(STEP_PARTS)
    del lines[cut]
    assert all(ln.endswith(" calls") and "s over " in ln for ln in lines)
    assert ((tmp_path / "on.sketch").read_bytes()
            == (tmp_path / "off.sketch").read_bytes())


def test_last_stage_times_name_the_stages(tmp_path):
    g = _genomes(tmp_path / "g")
    p = SketchParams(hv_d=256, scaled=40)
    sk = Sketcher(p, device="cpu", chunk_positions=2048, batch=2)
    sk.sketch_files(sorted(g.iterdir()), progress=False)
    assert set(sk.last_stage_times) == BATCH_STAGES
    assert all(v >= 0 for v in sk.last_stage_times.values())
    # 20,000 bp = a 16-chunk bucket: at seqpar_min_chunks=16 each genome
    # takes the tiled route on the CPU, one huge span each
    sk = Sketcher(p, device="cpu", chunk_positions=2048, batch=2,
                  seqpar_min_chunks=16)
    before = dict(sk.last_stage_times)
    sk.sketch_files(sorted(g.iterdir()), progress=False)
    assert before == {}
    assert set(sk.last_stage_times) == BATCH_STAGES | {"huge_tiled"}
    assert sk._timer is None  # no span outlives the call


@pytest.mark.parametrize("route", ["one_row", "tiled"])
def test_huge_span_excludes_the_steps(monkeypatch, route):
    """The huge span is charged with the route's own work only: with the
    steps' spans inside it, the totals add up to the call's wall time."""
    rng = np.random.default_rng(32)
    codes = rng.integers(0, 4, size=40_000).astype(np.uint8)
    p = SketchParams(hv_d=256, scaled=40)
    sk = Sketcher(p, device="cpu", chunk_positions=2048, batch=2,
                  seqpar_min_chunks=16)
    monkeypatch.setattr(sk, "_huge_route", lambda g: (route, []))
    sk._timer = ttiming.SketchTimer()
    t0 = time.monotonic()
    sk.sketch_codes(codes)
    wall = time.monotonic() - t0
    timer, sk._timer = sk._timer, None
    timer.resolve()
    assert set(timer.totals) == BATCH_STAGES - {
        "io_pool", "fasta_read", "compress"} | {f"huge_{route}"}
    assert timer.counts[f"huge_{route}"] == 1
    assert 0 <= sum(timer.totals.values()) <= wall
