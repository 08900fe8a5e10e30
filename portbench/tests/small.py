"""Cells of the benchmark cut to a size a CPU test runs in seconds."""

from pathlib import Path

import torch

from portbench.harness import runner, spec

ROOT = Path(__file__).resolve().parents[2]
SPEC = spec.Spec(ROOT)


def small(cell_name: str):
    """(cell, config, mix) with the pool at 4 genomes of about 60 kbp, or
    the database at 512 rows and 128 queries."""
    cell = SPEC.cell(cell_name)
    config = SPEC.config(cell["config"])
    mix = SPEC.traffic(cell["traffic"])
    if "genomes" in config:
        config["genomes"] = 4
        config["assumed"]["genome_bp"].update(median=60000, min=20000,
                                              max=200000)
        config["assumed"]["contigs"]["max"] = 20
        if "copies" in mix:
            mix["copies"] = 2
    else:
        config["rows"] = 512
        mix.update(queries=128, self_queries=32)
    return cell, config, mix


def run_small(cell_name: str, seed: int = 2**31 + 11, seconds: float = 0.3,
              trace: bool = False, device: str = "cpu"):
    cell, config, mix = small(cell_name)
    devices = [torch.device(device)] * cell["chips"]
    return runner.run_cell(SPEC, cell, seed, seconds, trace, devices, 0.0,
                           config, mix)
