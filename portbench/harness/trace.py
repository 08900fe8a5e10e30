"""The device trace of a measured window, reduced to what the metrics read.

``torch.profiler`` records the card's kernels, copies and sets (CUPTI) and
the host's operations and the benchmark's spans (``portbench:<name>``).
From the events inside the ``portbench:window`` range this keeps, per
device, the union of device intervals (busy seconds), kernel time and
event counts by name, host-to-device copy time, and the idle gaps labelled
by what the host was doing: the innermost benchmark span and the innermost
host operation around the gap's middle.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

WINDOW = "portbench:window"


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: Dict[int, float]  # device index -> union of device intervals
    kernel_s: Dict[str, float]  # kernel name -> seconds, all devices
    kernel_n: Dict[str, int]  # kernel name -> events
    op_s: Dict[str, float]  # every device op (kernels, copies, sets)
    htod_s: float  # host-to-device copies, summed over devices
    idle_by_host: Dict[str, float]  # host activity -> idle device seconds

    def mean_busy_s(self, n_devices: int) -> float:
        return sum(self.busy_s.values()) / n_devices

    def kernel_time(self, pattern: str) -> Tuple[float, int]:
        """(seconds, events) of the kernels whose name holds pattern."""
        s = sum(v for k, v in self.kernel_s.items() if pattern in k)
        n = sum(v for k, v in self.kernel_n.items() if pattern in k)
        return s, n

    def all_kernels_s(self) -> float:
        return sum(self.kernel_s.values())

    def breakdown(self, n_devices: int) -> dict:
        top = sorted(self.op_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:160], v] for k, v in top],
                "idle_gaps": [[k[:160], v / n_devices] for k, v in gaps]}


def _is_device(ev) -> bool:
    """A kernel, copy or set on a card; not the device-side copy of a host
    range (record_function), which marks no work of the card's."""
    if not str(ev.device_type()).endswith("CUDA"):
        return False
    annotation = getattr(ev, "is_user_annotation", None)
    return not ((annotation is not None and annotation())
                or ev.name().startswith("portbench:"))


def _union(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _labels(host, mids: List[int]) -> List[str]:
    """What the host was doing at each time of mids (sorted): the innermost
    benchmark span and the innermost host operation open at that time."""
    host = sorted(host)
    out, stack, i = [], [], 0
    for t in mids:
        while i < len(host) and host[i][0] <= t:
            s, e, name = host[i]
            while stack and stack[-1][1] < s:
                stack.pop()
            stack.append((s, e, name))
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        span = next((n[len("portbench:"):] for _, _, n in reversed(stack)
                     if n.startswith("portbench:")), "outside spans")
        op = stack[-1][2] if stack else ""
        out.append(f"{span} / {'python' if op.startswith('portbench:') else op}")
    return out


def reduce(prof, min_gap_ns: int = 10_000) -> Optional[Trace]:
    """The Trace of a finished profile, or None when it holds no window."""
    events = prof.profiler.kineto_results.events()
    win = [e for e in events if e.name() == WINDOW]
    if not win:
        return None
    w0 = min(e.start_ns() for e in win)
    w1 = max(e.end_ns() for e in win)
    busy_iv: Dict[int, List[Tuple[int, int]]] = collections.defaultdict(list)
    kernel_s: Dict[str, float] = collections.defaultdict(float)
    kernel_n: Dict[str, int] = collections.Counter()
    op_s: Dict[str, float] = collections.defaultdict(float)
    htod = 0.0
    host = []
    for e in events:
        s, end = e.start_ns(), e.end_ns()
        if end < w0 or s > w1:
            continue
        name = e.name()
        if str(e.device_type()).endswith("CUDA") and not _is_device(e):
            continue
        if _is_device(e):
            s, end = max(s, w0), min(end, w1)
            busy_iv[e.device_index()].append((s, end))
            sec = (end - s) / 1e9
            op_s[name] += sec
            if name.startswith("Memcpy"):
                htod += sec if "HtoD" in name else 0.0
            elif not name.startswith("Memset"):
                kernel_s[name] += sec
                kernel_n[name] += 1
        elif name != WINDOW:
            host.append((s, end, name))
    busy, gaps = {}, []
    for dev, iv in busy_iv.items():
        merged = _union(iv)
        busy[dev] = sum(e - s for s, e in merged) / 1e9
        edges = [w0] + [x for se in merged for x in se] + [w1]
        for a, b in zip(edges[::2], edges[1::2]):
            if b - a >= min_gap_ns:
                gaps.append(((a + b) // 2, b - a))
    gaps.sort()
    idle: Dict[str, float] = collections.defaultdict(float)
    for (_, length), label in zip(gaps, _labels(host, [m for m, _ in gaps])):
        idle[label] += length / 1e9
    return Trace((w1 - w0) / 1e9, busy, dict(kernel_s), dict(kernel_n),
                 dict(op_s), htod, dict(idle))

