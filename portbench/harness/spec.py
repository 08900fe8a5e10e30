"""Finds the parts of a cell by name: its entry in ``BENCHMARK.json``, its
configuration's file, its traffic mix (``portbench/traffic/<mix>.json``),
the mix's entry into the program (``portbench/entries/<entry>.py``, a class
``ENTRY``; see ``harness/entry.py``) and the reader of each metric it
reports (``portbench/metrics/<metric>.py``, a function ``read(run)`` that
gives a number, or None where the run holds nothing to read).

A reader may name the program's counters it reads (``COUNTERS``: {name:
"module:attribute.attribute"}), read before and after the window; and a
kernel whose trace events must match a launch counter (``KERNEL``, a part
of the kernel's name, and ``COUNTER``, one of its counters).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]


class SpecError(RuntimeError):
    pass


class Spec:
    def __init__(self, root: Path):
        path = root / "BENCHMARK.json"
        if not path.exists():
            raise SpecError(f"no BENCHMARK.json in {root}")
        self.root = root
        self.bench = json.loads(path.read_text())

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise SpecError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise SpecError(f"no config {name!r} in BENCHMARK.json")

    @staticmethod
    def traffic(name: str) -> dict:
        path = BENCH / "traffic" / f"{name}.json"
        if not path.exists():
            raise SpecError(f"no traffic mix {path}")
        return json.loads(path.read_text())

    def metrics(self, cell: dict, trace: bool) -> List[dict]:
        """The cell's end-to-end metrics (trace 0) or per-layer ones."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if "workloads" not in m or cell["name"] in m["workloads"]]


def _load(folder: str, name: str) -> ModuleType:
    """The module of ``portbench/<folder>/<name>.py``, loaded from its file."""
    path = BENCH / folder / f"{name}.py"
    if not path.exists():
        raise SpecError(f"no {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str) -> ModuleType:
    """The reader module of a metric."""
    return _load("metrics", metric)


def entry(name: str) -> type:
    """The class of an entry into the program."""
    return _load("entries", name).ENTRY


def counter_value(ref: str) -> int:
    """The value of a program counter named "module:attr.attr"."""
    mod, attrs = ref.split(":")
    obj = importlib.import_module(mod)
    for a in attrs.split("."):
        obj = getattr(obj, a)
    return int(obj)


def counters(readers: List[ModuleType]) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for r in readers:
        out.update(getattr(r, "COUNTERS", {}))
    return out
