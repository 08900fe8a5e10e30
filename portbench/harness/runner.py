"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line's fields."""

from __future__ import annotations

import dataclasses
import gc
import json
import shutil
import statistics
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional

import torch

from portbench.harness import entry as entry_mod
from portbench.harness import spec as spec_mod
from portbench.harness import trace as trace_mod


@dataclasses.dataclass
class RunData:
    """What a metric's reader reads."""

    cell: dict
    config: dict
    mix: dict
    n_devices: int
    setup_s: float
    window_s: float
    calls: int
    work: Dict[str, float]  # units completed in the window
    stages: Dict[str, float]  # the program's host stage spans, summed
    span_s: Dict[str, float]  # the benchmark's spans: seconds
    span_n: Dict[str, int]  # and count
    counters: Dict[str, int]  # the program's counters over the window
    needed: Dict[str, float]  # bounds of the work the window needed, s
    trace: Optional[trace_mod.Trace]
    unmatched: set  # kernels whose trace events miss launches


def _sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def run_cell(spec: spec_mod.Spec, cell: dict, seed: int, seconds: float,
             trace: bool, devices: List[torch.device], t0: float,
             config: Optional[dict] = None, mix: Optional[dict] = None) -> dict:
    """The result of one run (the fields of the result line), ``checks``
    last. t0: the process's start on the monotonic clock; config and mix
    replace the cell's files (tests run cells at a small size)."""
    config = config or spec.config(cell["config"])
    mix = mix or spec.traffic(cell["traffic"])
    metrics = spec.metrics(cell, trace)
    readers = {m["name"]: spec_mod.reader(m["name"]) for m in metrics}
    counter_refs = spec_mod.counters(list(readers.values()))
    tmp = Path(tempfile.mkdtemp(prefix="portbench-"))
    spans = entry_mod.Spans()
    cuda = devices[0].type == "cuda"
    try:
        entry = spec_mod.entry(mix["entry"])(config, mix, seed, devices, tmp,
                                             spans)
        entry.setup()
        _sync(devices)
        spans.clear()
        entry.stages.clear()
        if cuda:
            for d in devices:
                torch.cuda.reset_peak_memory_stats(d)
        before = {k: spec_mod.counter_value(v) for k, v in counter_refs.items()}
        prof = None
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            spans.tracing = True
        error = None
        t_start = time.monotonic()
        setup_s = t_start - t0
        with spans("window"):
            try:
                while time.monotonic() - t_start < seconds:
                    entry.step()
                entry.drain()
                _sync(devices)
            except Exception:  # the run goes on to report it as failed
                error = traceback.format_exc()
        window_s = time.monotonic() - t_start
        spans.tracing = False
        if prof is not None:
            prof.stop()
        after = {k: spec_mod.counter_value(v) for k, v in counter_refs.items()}
        peak = max((torch.cuda.max_memory_allocated(d) for d in devices),
                   default=0) if cuda else 0
        tr = trace_mod.reduce(prof) if prof is not None else None
        del prof
        if error:
            _log(f"a call failed in the window:\n{error}")
        entry.release()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        want = entry.reference()
        checks = entry.check(want)
        needed = entry.needed(want)
        counters = {k: after[k] - before[k] for k in counter_refs}
        unmatched = set()
        for r in readers.values():
            kernel, counter = getattr(r, "KERNEL", None), getattr(r, "COUNTER", None)
            if tr is None or kernel is None or kernel in unmatched:
                continue
            _, events = tr.kernel_time(kernel)
            _log(f"trace events of {kernel}: {events}; launches counted by "
                 f"{counter_refs[counter]}: {counters[counter]}")
            if events != counters[counter]:
                unmatched.add(kernel)
                _log(f"{kernel}: events and launches differ; its roofline is "
                     f"not reported")
        rd = RunData(cell, config, mix, len(devices), setup_s, window_s,
                     entry.calls, dict(entry.work), dict(entry.stages),
                     dict(spans.total), dict(spans.count), counters,
                     needed, tr, unmatched)
        _log("run " + json.dumps({
            "setup_s": setup_s, "window_s": window_s, "calls": entry.calls,
            "work": rd.work, "stages_s": rd.stages, "spans_s": rd.span_s,
            "spans_n": rd.span_n, "counters": counters, "needed_s": rd.needed,
            "spans_ms_quartiles": {
                k: [round(1e3 * x, 3) for x in statistics.quantiles(v, n=4)]
                for k, v in spans.each.items() if len(v) > 1}}))
        values = {}
        for m in metrics:
            v = readers[m["name"]].read(rd)
            if v is not None:
                values[m["name"]] = {"value": float(v), "unit": m["unit"]}
        attempted = entry.attempted()
        failed = attempted - entry.completed() if error else 0
        correct = error is None and entry_mod.passes(checks)
        device = {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(devices[0]) if cuda else "cpu",
            "count": len(devices),
            "memory_peak_bytes": int(peak),
        }
        if tr is not None:
            device["busy_s"] = tr.mean_busy_s(len(devices))
            device["window_s"] = tr.window_s
        result = {"correct": bool(correct), "attempted": int(attempted),
                  "failed": int(failed), "metrics": values, "device": device}
        if tr is not None:
            result["breakdown"] = tr.breakdown(len(devices))
        result["checks"] = {k: {"value": v, "limit": lim}
                            for k, (v, lim) in checks.items()}
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
