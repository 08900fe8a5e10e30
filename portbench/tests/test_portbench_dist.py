"""The derep cell on the CPU at a small size: a broken timed path reads
not correct through ``tsv_rows_wrong``, a traced run reports the cell's
per-layer metrics, and the control fails."""

import numpy as np
import pytest

from portbench import control
from portbench.tests.small import SPEC, run_small, small

CELL = "gtdb_r220_genomes.derep_95"


def _dist_fault(kind):
    from hypergen_tpu_torch.models.comparator import Comparator

    orig = Comparator.ani_pairs_thresholded

    def pairs(self, *a, **kw):
        ri, qi, ani, n_total = orig(self, *a, **kw)
        if kind == "unchanged":  # the pair lists as the call starts
            return ri[:0], qi[:0], ani[:0], n_total
        if kind == "half":  # every other pair dropped
            return ri[::2], qi[::2], ani[::2], n_total
        ani = ani.copy()  # one answer altered where it is produced
        ani[len(ani) // 2] += np.float32(0.5)
        return ri, qi, ani, n_total

    return Comparator, "ani_pairs_thresholded", pairs


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_dist_is_not_correct(monkeypatch, fault):
    monkeypatch.setattr(*_dist_fault(fault))
    res = run_small(CELL)
    assert not res["correct"], (fault, res["checks"])
    assert res["failed"] == 0  # the comparison caught it, not a crash
    assert res["checks"]["tsv_rows_wrong"]["value"] > 0


def test_traced_derep_reports_its_per_layer_metrics():
    res = run_small(CELL, trace=True)
    assert res["correct"]
    allowed = {m["name"] for m in SPEC.metrics(SPEC.cell(CELL), True)}
    # every one but the kernels' roofline, which needs the card's kernels
    assert set(res["metrics"]) == allowed - {"dist.kernels_roofline"}
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert got["device_idle_pct.search"] == 100.0  # no card
    assert got["search.h2d_ms_per_call"] == 0.0
    # the pairs i >= j of the one diagonal tile also pass the card's test
    assert got["dist.candidates_per_kept"] > 2.0
    assert all(v > 0 for k, v in got.items() if k != "search.h2d_ms_per_call")


def test_derep_control_fails(tmp_path):
    _, config, mix = small(CELL)
    checks = control.control(config, mix, 2**31 + 99, "cpu", tmp_path, 2)
    lines = int(config["rows"] // config["family"] * 120 * 0.5)
    assert checks["tsv_rows_wrong"][0] > 2 * lines
