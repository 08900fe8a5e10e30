"""What the traffic's entries into the program share.

An entry is the class ``ENTRY`` of ``portbench/entries/<entry>.py``, which a
mix names (``portbench/traffic/<mix>.json``, key ``entry``) and
``spec.entry`` loads from its file. It is run from the mix's parameters:

- ``inputs()`` makes the cell's inputs from the seed, without the program;
  ``setup()`` makes them, readies the program and warms it up;
- ``step()`` makes one call of the closed loop, ``drain()`` finishes what
  is in flight and ``release()`` frees the program's state;
- after the window, ``reference(hv_bits)`` gives the plain reference's
  outputs over the inputs, ``check(want)`` compares what the timed calls
  produced with them ({name: (number, limit)}), and ``needed(want)`` gives
  the bounds of the work the window's calls needed ({name: seconds}, read
  by the rooflines);
- ``stand_in(outputs, calls)`` puts outputs of the reference, made at
  another precision, where ``calls`` timed calls would have put the
  program's: the control, judged by the same ``check``.

An entry counts its work in ``work`` and its calls in ``calls``, times its
calls into the program with ``span`` and sums the program's host stage
spans in ``stages``.
"""

from __future__ import annotations

import collections
import contextlib
import time
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

Checks = Dict[str, Tuple[float, float]]


class Spans:
    """Host spans of the benchmark's own, around its calls into the
    program: seconds and count by name, and a profiler range
    (``portbench:<name>``) when tracing."""

    def __init__(self):
        self.total: Dict[str, float] = collections.defaultdict(float)
        self.count: Dict[str, int] = collections.Counter()
        self.each: Dict[str, List[float]] = collections.defaultdict(list)
        self.tracing = False

    def clear(self) -> None:
        self.total.clear()
        self.count.clear()
        self.each.clear()

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = (torch.profiler.record_function(f"portbench:{name}")
              if self.tracing else contextlib.nullcontext())
        t = time.perf_counter()
        with rf:
            try:
                yield
            finally:
                dt = time.perf_counter() - t
                self.total[name] += dt
                self.count[name] += 1
                self.each[name].append(dt)


def passes(checks: Checks) -> bool:
    """Whether every compared number is within its limit."""
    return all(v <= lim for v, lim in checks.values())


def rows_wrong(got_hv: np.ndarray, got_n2: np.ndarray, want_hv: np.ndarray,
               want_n2: np.ndarray) -> int:
    """Sketch rows whose HV or norm differs from the reference's."""
    bad = (got_hv != want_hv).any(axis=1) | (got_n2 != want_n2)
    return int(bad.sum())


def lines_wrong(got: List[str], want: List[str]) -> int:
    """TSV lines that differ from the reference's, place by place, and
    those one side lacks."""
    return sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))


class Entry:
    def __init__(self, config: dict, mix: dict, seed: int, devices: list,
                 tmp: Path, spans: Spans):
        self.config, self.mix, self.seed = config, mix, seed
        self.devices = devices
        self.device = devices[0]
        self.tmp = tmp
        self.span = spans
        self.work: Dict[str, float] = collections.Counter()
        self.stages: Dict[str, float] = collections.defaultdict(float)
        self.calls = 0
        self.started = 0  # units (genomes, queries) whose call began

    def attempted(self) -> int:
        return self.started

    def completed(self) -> int:
        return int(self.work["genomes"] + self.work["queries"])

    def drain(self) -> None:
        pass

    def release(self) -> None:
        pass
