"""Per-stage wall-time instrumentation and optional profiler traces.

Counterpart of ``hypergen_tpu.utils.timing``. ``StageTimer`` is the JAX
package's class: named host-clock spans and the same report. The sketch
path (``Sketcher``) uses ``SketchTimer``, a StageTimer whose spans may nest
and may be timed on a CUDA stream. Its host spans tile the calling
thread's time, so they add up to the wall: ``io_pool``, ``fasta_read``,
``pack``, ``dispatch`` (enqueueing a step), ``collect`` (the wait for a
step's outputs and its capacity check) and ``compress``, named after the
JAX package's spans where they match, and ``huge:<route>``. Its device
spans (``upload``, ``hash``, ``compact``, ``distinct``, ``encode``,
``download``) are the stream's busy time, kept apart: with batches in
flight they overlap the host spans.

``maybe_profile`` captures a ``torch.profiler`` trace (``HG_TRACE_DIR`` in
the CLI) where the JAX package captures a ``jax.profiler`` one.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List


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


class _Span:
    __slots__ = ("name", "seconds", "events", "children")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0
        self.events = None  # (start, end) CUDA events of a device span
        self.children: List["_Span"] = []

    def elapsed(self) -> float:
        """A device span's time: waits for its end event."""
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end) / 1e3


class SketchTimer(StageTimer):
    """A StageTimer for the sketch path.

    ``stage(name, device=True)`` on a CUDA device is timed by a pair of
    CUDA events recorded on the device's current stream: recording adds no
    wait on the host. Such a span goes to ``device_totals`` and
    ``device_counts``, whose sum is the stream's busy time, and stays out
    of the host spans around it. Every other span (all of them without a
    CUDA stream) is timed by the host clock into ``totals``; a span opened
    inside another is charged to itself only, so that the totals add up to
    the wall time they cover. Spans are folded in by ``resolve()``, which
    reads the events: call it once the path has waited for the device.
    """

    def __init__(self, device=None):
        """device: the torch.device the path runs on (None: host only)."""
        super().__init__()
        self._stream = None
        if device is not None and device.type == "cuda":
            import torch

            self._stream = torch.cuda.current_stream(device)
        self._spans: List[_Span] = []
        self._open: List[_Span] = []
        self._device_spans: List[_Span] = []
        self.device_totals: Dict[str, float] = defaultdict(float)
        self.device_counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, device: bool = False):
        span = _Span(name)
        if device and self._stream is not None:
            import torch

            span.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self._device_spans.append(span)
            span.events[0].record(self._stream)
            try:
                yield
            finally:
                span.events[1].record(self._stream)
            return
        if self._open:
            self._open[-1].children.append(span)
        self._spans.append(span)
        self._open.append(span)
        t0 = time.monotonic()
        try:
            yield
        finally:
            self._open.pop()
            span.seconds = time.monotonic() - t0

    def resolve(self) -> None:
        for span in self._spans:
            own = span.seconds - sum(c.seconds for c in span.children)
            self.totals[span.name] += own
            self.counts[span.name] += 1
        for span in self._device_spans:
            self.device_totals[span.name] += span.elapsed()
            self.device_counts[span.name] += 1
        self._spans, self._device_spans = [], []

    def report(self) -> str:
        """The host spans, then (on a CUDA device) the device spans under a
        line with their sum, the stream's busy time."""
        text = super().report()
        if self.device_totals:
            busy = sum(self.device_totals.values())
            text += (f"\ndevice spans (CUDA events; busy {busy:.3f}s):\n"
                     + _report(self.device_totals, self.device_counts))
        return text


@contextlib.contextmanager
def maybe_profile(trace_dir: str = "", cuda: bool = False):
    """Capture a torch.profiler trace when trace_dir is set: CPU activity,
    and CUDA activity with cuda=True. The Chrome trace goes to
    trace_dir/hypergen_<time>_p<process index>.json, one file for each
    process of a pod."""
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

