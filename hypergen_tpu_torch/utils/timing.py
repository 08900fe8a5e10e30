"""Per-stage wall-time instrumentation and optional profiler traces.

Counterpart of ``hypergen_tpu.utils.timing``. ``StageTimer`` is the JAX
package's class: named host-clock spans and the same report. The sketch
path (``Sketcher.sketch_files``) uses ``SketchTimer``, a StageTimer whose
spans may be timed on a CUDA stream and may nest. The port's sketch step
is not the JAX package's relay pipeline, so its span names are its own
(``io_pool``, ``fasta_read``, ``pack``, ``upload``, ``hash``, ``compact``,
``distinct``, ``encode``, ``compress``, ``huge:<route>``), not the relay
stages ``upload_wait``, ``collect`` and ``pack+dispatch``.

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
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(
                f"{name}: {self.totals[name]:.3f}s over {self.counts[name]} calls"
            )
        return "\n".join(lines)


class _Span:
    __slots__ = ("name", "seconds", "events", "children")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0
        self.events = None  # (start, end) CUDA events of a device span
        self.children: List["_Span"] = []

    def elapsed(self) -> float:
        if self.events is not None:
            start, end = self.events
            end.synchronize()
            self.seconds = start.elapsed_time(end) / 1e3
            self.events = None
        return self.seconds


class SketchTimer(StageTimer):
    """A StageTimer for the sketch path.

    ``stage(name, device=True)`` on a CUDA device is timed by a pair of
    CUDA events recorded on the device's current stream: the span's time
    is the stream's, and recording adds no wait on the host. Every other
    span is timed by the host clock. A span opened inside another is
    charged to itself only: the outer span's total excludes the time of
    the spans inside it, so the totals add up to the wall time they cover.
    Spans are folded into ``totals`` and ``counts`` by ``resolve()``,
    which reads the events: call it once the path has waited for the
    device.
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

    @contextlib.contextmanager
    def stage(self, name: str, device: bool = False):
        span = _Span(name)
        if self._open:
            self._open[-1].children.append(span)
        self._spans.append(span)
        self._open.append(span)
        timed = device and self._stream is not None
        if timed:
            import torch

            span.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            span.events[0].record(self._stream)
        t0 = time.monotonic()
        try:
            yield
        finally:
            self._open.pop()
            if timed:
                span.events[1].record(self._stream)
            else:
                span.seconds = time.monotonic() - t0

    def resolve(self) -> None:
        for span in self._spans:
            own = span.elapsed() - sum(c.elapsed() for c in span.children)
            self.totals[span.name] += own
            self.counts[span.name] += 1
        self._spans = []


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

