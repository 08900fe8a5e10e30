"""The plain references equal the port's CPU path on small inputs, their
controls do not, and neither they nor the harness import JAX or (for the
references) the program."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import control
from portbench.harness import data
from portbench.reference import search as ref_search
from portbench.reference import sketch as ref_sketch
from portbench.tests.small import small

BENCH = Path(__file__).resolve().parents[1]


def _sketch_case(tmp_path, scaled):
    _, config, _ = small("gtdb_r220_build.files_mix")
    config["sketch"]["scaled"] = scaled
    genomes = data.make_pool(config, 2**32 + 3, "cpu")
    paths = data.write_pool(genomes, tmp_path, 80)
    return config, genomes, paths


@pytest.mark.parametrize("scaled", [50, 1500])
def test_sketch_reference_equals_the_ports_cpu_sketch(tmp_path, scaled):
    from hypergen_tpu_torch.models.sketcher import Sketcher
    from hypergen_tpu_torch.params import SketchParams

    config, genomes, paths = _sketch_case(tmp_path, scaled)
    s = config["sketch"]
    hv, n2, n_h = ref_sketch.sketch_genomes([g.codes() for g in genomes], s,
                                            "cpu", block=1 << 15)
    assert (n_h > 0).all()
    p = SketchParams(ksize=s["ksize"], scaled=s["scaled"], hv_d=s["hv_d"],
                     seed=s["seed"])
    got = Sketcher(p, device="cpu").sketch_files(paths, progress=False)
    for i, f in enumerate(got):
        assert np.array_equal(f.decompress(), hv[i])
        assert f.hv_norm_2 == n2[i]


@pytest.mark.parametrize("cell", ["gtdb_r220_build.files_mix",
                                  "gtdb_r220_build.packed_stream"])
def test_sketch_control_fails(tmp_path, cell):
    _, config, mix = small(cell)
    config["sketch"]["scaled"] = 50
    checks = control.control(config, mix, 2**32 + 3, "cpu", tmp_path, 2)
    # genomes this small keep fewer hashes, so some HVs fit int8 whole; at
    # the cell's 0.6-12 Mbp most HVs exceed it (control.py on the card)
    assert checks["rows_wrong"][0] > checks["rows_wrong"][1]
    assert checks["rows_missing"] == (0, 0)


def _search_case():
    _, config, mix = small("gtdb_r220_db.search_4096")
    db, q = data.make_database(config, mix, 2**31 + 99, "cpu")
    return config, mix, db, q


def test_search_reference_equals_the_ports_cpu_search(tmp_path):
    from hypergen_tpu_torch.io.sketch_db import ShardedDB
    from hypergen_tpu_torch.parallel.search import topk_search, write_search_tsv

    config, mix, db, q = _search_case()
    k = config["sketch"]["ksize"]
    want = ref_search.search_tsv(db.hvs, db.norms, db.names, q.hvs, q.norms,
                                 q.names, k, mix["top_k"],
                                 mix["ani_threshold"], "cpu", tile=100)
    ani, idx, dot = topk_search([torch.device("cpu")], db.hvs, db.norms,
                                q.hvs, q.norms, k, mix["top_k"])
    s = config["sketch"]
    qdb = ShardedDB(k, s["scaled"], True, s["seed"], s["hv_d"], q.names,
                    q.hvs, q.norms)
    write_search_tsv(tmp_path / "s.tsv", db.names, db.norms, qdb, ani, idx,
                     dot, mix["ani_threshold"])
    got = (tmp_path / "s.tsv").read_text().splitlines(keepends=True)
    assert len(want) > mix["queries"]
    assert got == want
    # every database row among the queries finds itself first, at 100
    first = {}
    for line in want:
        ref, query, ani_s = line.rstrip("\n").split("\t")
        first.setdefault(query, (ref, ani_s))
    for name in q.names[: mix["self_queries"]]:
        assert first[name] == (name, "100.000")


def test_search_control_fails(tmp_path):
    _, config, mix = small("gtdb_r220_db.search_4096")
    checks = control.control(config, mix, 2**31 + 99, "cpu", tmp_path, 2)
    # more than half of the lines of each of the two calls
    assert checks["tsv_rows_wrong"][0] > mix["queries"] * mix["top_k"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_references_import_nothing_of_the_program_or_jax():
    for path in (BENCH / "reference").glob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert tops <= {"__future__", "typing", "numpy", "torch"}, (path, tops)


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "hypergen_tpu"}, path
