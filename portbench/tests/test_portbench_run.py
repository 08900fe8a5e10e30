"""Runs of every cell on the CPU at a small size: the harness drives the
program, finds every part by name, reports what the contract asks, and its
comparison turns false when the timed path is broken underneath."""

import json
import re
from pathlib import Path

import numpy as np
import pytest

from portbench.harness import spec
from portbench.tests.small import ROOT, SPEC, run_small

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_part_is_found_by_name():
    assert BENCH["paths"] == ["portbench"]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"])
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
        for w in m.get("workloads", []):
            assert w in CELLS
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).exists() and NAME.match(c["name"])
        assert len(c["why"]) <= 200 and len(c["source"]) <= 200
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").exists()
        entry = spec.entry(SPEC.traffic(w["traffic"])["entry"])
        for method in ("inputs", "setup", "step", "reference", "check",
                       "needed", "stand_in"):
            assert callable(getattr(entry, method)), (entry, method)
        e2e = [m["name"] for m in SPEC.metrics(w, False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert SPEC.metrics(w, True)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(cell):
    res = run_small(cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    want = {m["name"] for m in SPEC.metrics(SPEC.cell(cell), False)}
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", ["gtdb_r220_build.files_mix",
                                  "gtdb_r220_db.search_4096"])
def test_traced_run_reports_per_layer_metrics(cell):
    res = run_small(cell, trace=True)
    assert res["correct"]
    allowed = {m["name"] for m in SPEC.metrics(SPEC.cell(cell), True)}
    assert res["metrics"] and set(res["metrics"]) <= allowed
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


# -- the timed path broken underneath ------------------------------------------

def _sketch_fault(kind):
    from hypergen_tpu_torch.models.sketcher import Sketcher

    orig = Sketcher.collect_batch

    def collect(self, handle):
        res = orig(self, handle)
        if kind == "unchanged":  # the step hands back its initial state
            return [{"hv": np.zeros_like(r["hv"]), "norm2": 0, "n_hashes": 0}
                    for r in res]
        if kind == "half":  # half the batch left out, filled from the rest
            h = max(1, len(res) // 2)
            return res[:h] + [dict(res[i % h]) for i in range(h, len(res))]
        r0 = dict(res[0])  # one answer altered where it is produced
        r0["hv"] = r0["hv"].copy()
        r0["hv"][7] += 1
        return [r0] + res[1:]

    return Sketcher, "collect_batch", collect


def _search_fault(kind):
    from hypergen_tpu_torch.parallel import search

    if kind == "exchange":  # only the first card's candidates are merged
        orig_merge = search._merge

        def merge(vs, ids, ds, k_top):
            return orig_merge(vs[:1], ids[:1], ds[:1], k_top)

        return search, "_merge", merge
    if kind == "altered":
        orig_ani = search._exact_ani

        def exact(*a):
            ani = orig_ani(*a).copy()
            ani[0, 0] += np.float32(0.5)
            return ani

        return search, "_exact_ani", exact
    orig = search.topk_search

    def topk(*a, **k):
        ani, idx, dot = orig(*a, **k)
        if kind == "unchanged":  # the running top-k as it starts
            return np.full_like(ani, -np.inf), np.zeros_like(idx), \
                np.zeros_like(dot)
        h = ani.shape[0] // 2  # half the queries left out, filled from the rest
        for t in (ani, idx, dot):
            t[h:] = t[: t.shape[0] - h]
        return ani, idx, dot

    return search, "topk_search", topk


FAULTS = [(c, f) for c in ("gtdb_r220_build.files_mix",
                           "gtdb_r220_build.packed_stream")
          for f in ("unchanged", "half", "altered")] + \
    [(c, f) for c in ("gtdb_r220_db.search_4096",
                      "gtdb_r220_db.search_4096_4card")
     for f in ("unchanged", "half", "altered")] + \
    [("gtdb_r220_db.search_4096_4card", "exchange")]


@pytest.mark.parametrize("cell, fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    target = _sketch_fault(fault) if "build" in cell else _search_fault(fault)
    monkeypatch.setattr(*target)
    res = run_small(cell)
    assert not res["correct"], (fault, res["checks"])
    assert res["failed"] == 0  # the comparison caught it, not a crash
    assert any(c["value"] > c["limit"] for c in res["checks"].values())
