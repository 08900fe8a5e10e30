"""Spans, per-stage wall-time instrumentation and optional profiler traces.

Counterpart of ``hypergen_tpu.utils.timing``. ``span(name)`` is the port's
one span primitive: it adds its wall nanoseconds and a count to the
process's totals (``SPANS.<name>.ns``, ``.n``; with ``cpu=True`` also the
calling thread's CPU nanoseconds, ``.cpu_ns``), and while a
``torch.profiler`` records it is also the range ``hg:<name>`` of the trace,
on the profiler's clock and nested in whatever range is open. With no
profiler recording it enters no profiler range. The thread's CPU clock is a
system call (2.3-3.4 us a reading on the H100 machine's host, more than a
whole span without it, 1.8-1.9 us), so only the spans whose CPU time is read
take it: ``pack`` and ``dispatch``. The port opens spans on its calling
thread only (the parser threads open none):

- the sketch path (``models/sketcher.py``): ``io_pool``, ``fasta_read``,
  ``pack``, ``dispatch``, ``collect``, ``compress``, ``huge_<route>``, and
  inside ``dispatch`` the host's enqueue of each part of the step
  (``sketcher.STEP_PARTS``);
- the ``.hgdb`` write and load (``io/sketch_db.py``): ``db_decompress``,
  ``db_save``, ``db_load_manifest``, ``db_load_assemble``,
  ``db_load_read`` and, for shards not in ``np.save``'s own layout,
  ``db_load_fallback``;
- the search call (``parallel/search.py``): ``search_mode_scan`` (the dot
  mode's reduction on the card and its read, once for the queries and
  once a tile on each card), ``search_upload``, ``search_dot_topk``,
  ``search_fetch``, ``search_host_chain``;
- `dist`'s pair path (``models/comparator.py``): ``dist_compare`` (a whole
  ``ani_pairs_thresholded`` or ``ani_pairs_streamed``), ``dist_preload``,
  and in each tile ``dist_fetch`` (the wait for the card and the copy to
  the host) and ``dist_host_chain``; ``dist_finish`` and ``dist_report``.

Beside the spans, ``count(name, n)`` adds to the process's integer counters
(``COUNTERS.<name>``, 0 for a name never counted). `dist` counts
``dist_candidates`` (pairs the card's margin test passes, fetched to the
host; every pair of a tile on the streamed path) and ``dist_kept`` (pairs
the host chain keeps: the report's rows when it has no top-k cap). Its
tile products are ``SPANS.dist_fetch.n``. The `dist` and `search` TSVs
count their rows in ``tsv_rows_native`` (formatted by ``csrc/tsv_rows.cpp``)
and ``tsv_rows_fallback`` (by ``np.char``, where the routine cannot run).
Every exact int8 product of `search` and `dist` counts its split
(``ops/ani.py``): ``dot_tiles_small`` (the 3-product one) or
``dot_tiles_split4`` (the 4-way one).

``StageTimer`` is the JAX package's class: named host-clock spans and the
same report. ``Sketcher.sketch_files`` uses ``SketchTimer``, a StageTimer
whose stages are spans and may nest. Its stages tile the calling thread's
time, so they add up to the wall (``Sketcher.last_stage_times``); the
step's parts stay out of that tiling (``dispatch`` includes them): their
span totals over the call are ``Sketcher.last_part_times``, and the
report (``HG_STAGE_TIMING`` in the CLI) lists them after the stages.

``maybe_profile`` captures a ``torch.profiler`` trace (``HG_TRACE_DIR`` in
the CLI) where the JAX package captures a ``jax.profiler`` one.
"""

from __future__ import annotations

import contextlib
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

class StageTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            dt = time.monotonic() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        return _report(self.totals, self.counts)


def _report(totals: Dict[str, float], counts: Dict[str, int]) -> str:
    lines = []
    for name in sorted(totals, key=totals.get, reverse=True):
        lines.append(f"{name}: {totals[name]:.3f}s over {counts[name]} calls")
    return "\n".join(lines)


class SpanTotal:
    """One span name's totals since the process started: wall nanoseconds
    (``time.perf_counter_ns``), the calling thread's CPU nanoseconds
    (``time.thread_time_ns``, spans opened with cpu=True) and the spans
    closed."""

    __slots__ = ("ns", "cpu_ns", "n")

    def __init__(self):
        self.ns = self.cpu_ns = self.n = 0


class SpanTotals:
    """The process's span totals by name, read as attributes
    (``SPANS.pack.ns``) or items; a name never opened reads zeros."""

    def __init__(self):
        self._by_name: Dict[str, SpanTotal] = {}

    def __getattr__(self, name: str) -> SpanTotal:
        if name.startswith("_"):
            raise AttributeError(name)
        return self[name]

    def __getitem__(self, name: str) -> SpanTotal:
        return self._by_name.get(name) or SpanTotal()

    def _add(self, name: str, ns: int, cpu_ns: int) -> None:
        t = self._by_name.get(name)
        if t is None:
            t = self._by_name[name] = SpanTotal()
        t.ns += ns
        t.cpu_ns += cpu_ns
        t.n += 1

    def snapshot(self, names: Sequence[str]) -> Dict[str, Tuple[int, int]]:
        """{name: (ns, n)} now, for a difference over an interval."""
        return {k: (self[k].ns, self[k].n) for k in names}


SPANS = SpanTotals()


class Counters(dict):
    """The process's integer counters by name, also read as attributes
    (``COUNTERS.dist_kept``); a name never counted reads 0."""

    def __getattr__(self, name: str) -> int:
        if name.startswith("_"):
            raise AttributeError(name)
        return self.get(name, 0)


COUNTERS = Counters()


def count(name: str, n: int = 1) -> None:
    """Add n to the counter ``COUNTERS.<name>``."""
    COUNTERS[name] = COUNTERS.get(name, 0) + n


class span:
    """``with span(name[, cpu=True]):`` a span of the port (module
    docstring); cpu=True also reads the thread's CPU clock. The clocks are
    read outside the profiler range, so that the span covers its range's
    own cost. ``ns`` holds the span's wall nanoseconds once it has closed."""

    __slots__ = ("name", "cpu", "ns", "_w0", "_c0", "_range")

    def __init__(self, name: str, cpu: bool = False):
        self.name, self.cpu = name, cpu
        self.ns = self._c0 = 0
        self._range = None

    def __enter__(self) -> "span":
        self._w0 = time.perf_counter_ns()
        if self.cpu:
            self._c0 = time.thread_time_ns()
        # no profiler can record before torch is imported. The range is
        # torch's fast record-function, entered without an operator call:
        # record_function's operator call, beside the parser threads, made
        # the sketch path's stages several times longer while traced
        torch = sys.modules.get("torch")
        if torch is not None and torch.autograd._profiler_enabled():
            self._range = torch._C._profiler._RecordFunctionFast(
                "hg:" + self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        cpu_ns = time.thread_time_ns() - self._c0 if self.cpu else 0
        self.ns = time.perf_counter_ns() - self._w0
        SPANS._add(self.name, self.ns, cpu_ns)


class _Stage:
    """One stage of a SketchTimer: a span whose own time (less the stages
    opened inside it) goes to the timer's totals when it closes."""

    __slots__ = ("timer", "span", "child_ns")

    def __init__(self, timer: "SketchTimer", sp: span):
        self.timer, self.span, self.child_ns = timer, sp, 0

    def __enter__(self) -> "_Stage":
        self.timer._open.append(self)
        self.span.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        sp, t = self.span, self.timer
        sp.__exit__(*exc)
        t._open.pop()
        if t._open:
            t._open[-1].child_ns += sp.ns
        t.totals[sp.name] += (sp.ns - self.child_ns) / 1e9
        t.counts[sp.name] += 1


class SketchTimer(StageTimer):
    """A StageTimer for the sketch path whose stages are spans (``span``).

    A stage opened inside another is charged to itself only, so that the
    totals add up to the wall time they cover. The spans named in `parts`
    run inside the stages and stay out of their tiling: ``resolve()`` puts
    their span totals over the timer's life in ``part_totals`` and
    ``part_counts``, and ``report()`` lists them after the stages.
    """

    def __init__(self, parts: Sequence[str] = ()):
        super().__init__()
        self._open: List[_Stage] = []
        self._parts0 = SPANS.snapshot(parts)
        self.part_totals: Dict[str, float] = {}
        self.part_counts: Dict[str, int] = {}

    def stage(self, name: str, cpu: bool = False) -> _Stage:
        return _Stage(self, span(name, cpu))

    def resolve(self) -> None:
        for name, (ns, n) in self._parts0.items():
            t = SPANS[name]
            if t.n > n:
                self.part_totals[name] = (t.ns - ns) / 1e9
                self.part_counts[name] = t.n - n

    def report(self) -> str:
        """The stages, then the parts under a line of their own."""
        text = super().report()
        if self.part_totals:
            text += ("\nstep parts (the host's enqueue, inside dispatch):\n"
                     + _report(self.part_totals, self.part_counts))
        return text


@contextlib.contextmanager
def maybe_profile(trace_dir: str = "", cuda: bool = False):
    """Capture a torch.profiler trace when trace_dir is set: CPU activity,
    and CUDA activity with cuda=True. The Chrome trace goes to
    trace_dir/hypergen_<time>_p<process index>.json, one file for each
    process of a pod; the port's spans are its ``hg:<name>`` ranges."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    from hypergen_tpu_torch.parallel.mesh import process_index

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    stamp = time.strftime("%Y%m%d_%H%M%S")
    out = Path(trace_dir) / f"hypergen_{stamp}_p{process_index()}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out))
