"""The port's `dist` of a collection against itself, byte for byte against
the benchmark's plain reference (``portbench/reference/dist.py``), on
seeded rows of the benchmark's database generator at a small size: through
``cli.run_dist`` on an .hgdb (the device-filtered path at -a 95, the
streamed path at -a 40), and through a Comparator of 128 x 128 tiles, whose
500 rows, in a seeded order, give diagonal, skipped and partial tiles.
Three rows are copies of one, so that ANIs tie, and one threshold is a
pair's own ANI."""

import argparse

import numpy as np
import pytest

from hypergen_tpu_torch.cli import THRESHOLDED_DIST_MIN, run_dist
from hypergen_tpu_torch.io.sketch_db import ShardedDB
from hypergen_tpu_torch.models.comparator import Comparator, write_ani_report
from portbench.harness import data
from portbench.reference import dist as ref_dist
from portbench.tests.small import small

SEED = 2**32 + 17


def _collection(rows=512):
    """The derep cell's collection at ``rows`` rows; rows 1 and 2 are
    copies of row 0."""
    _, config, _ = small("gtdb_r220_genomes.derep_95")
    db, _ = data.make_database(config, {"queries": 0, "self_queries": 0},
                               SEED, "cpu")
    db.hvs[1:3] = db.hvs[0]
    db.norms[1:3] = db.norms[0]
    db = data.Rows(db.names[:rows], db.hvs[:rows], db.norms[:rows])
    return config, db


def _want(db, config, threshold, **kw):
    return "".join(ref_dist.dist_tsv(db.hvs, db.norms, db.names,
                                     config["sketch"]["ksize"], threshold,
                                     "cpu", **kw))


def _run_dist(tmp_path, config, db, threshold) -> str:
    path = tmp_path / "c.hgdb"
    data.write_hgdb(db, path, config["sketch"], config["shards"])
    out = tmp_path / "dist.tsv"
    sk = config["sketch"]
    run_dist(argparse.Namespace(path_r=path, path_q=path, out=out,
                                ksize=sk["ksize"], hv_d=sk["hv_d"],
                                ani_th=threshold, device="cpu"))
    return out.read_text()


def _pair_ani(config, db, i, j) -> float:
    """The printed (host float32) ANI of rows i and j, as a float."""
    dot = np.array([int(db.hvs[i].astype(np.int64) @ db.hvs[j])], np.int32)
    return float(ref_dist.host_ani(dot, db.norms[i:i + 1], db.norms[j:j + 1],
                                   config["sketch"]["ksize"])[0])


@pytest.mark.parametrize("threshold", [95.0, 40.0],
                         ids=["thresholded", "streamed"])
def test_run_dist_equals_the_reference(tmp_path, threshold):
    config, db = _collection()
    got = _run_dist(tmp_path, config, db, threshold)
    want = _want(db, config, threshold)
    assert want.count("\n") > 1000
    assert got == want
    # the copies tie at 100 and come out in reverse enumeration order
    n = db.names
    assert want.startswith(f"{n[1]}\t{n[2]}\t100.000\n{n[0]}\t{n[2]}\t"
                           f"100.000\n{n[0]}\t{n[1]}\t100.000\n")


def test_run_dist_at_a_pairs_own_ani(tmp_path):
    """-a set to the ANI of rows (0, 5), which rows (1, 5) and (2, 5)
    share: the three are printed, last, ties reversed."""
    config, db = _collection()
    threshold = _pair_ani(config, db, 0, 5)
    assert threshold >= THRESHOLDED_DIST_MIN
    got = _run_dist(tmp_path, config, db, threshold)
    assert got == _want(db, config, threshold)
    n = db.names
    assert got.splitlines()[-3:] == [f"{n[i]}\t{n[5]}\t{threshold:.3f}"
                                     for i in (2, 1, 0)]


@pytest.mark.parametrize("path", ["thresholded", "streamed"])
def test_tiled_comparator_equals_the_reference(tmp_path, path):
    config, db = _collection(500)
    # a seeded order, so that families straddle tiles and kept pairs fall
    # off the diagonal tiles too
    order = np.random.default_rng(SEED).permutation(500)
    db = data.Rows([db.names[i] for i in order], db.hvs[order],
                   db.norms[order])
    sk = config["sketch"]
    sdb = ShardedDB(sk["ksize"], sk["scaled"], True, sk["seed"], sk["hv_d"],
                    db.names, db.hvs, db.norms)
    comp = Comparator(ksize=sk["ksize"], device="cpu", tile_m=128,
                      tile_n=128)
    threshold = 95.0 if path == "thresholded" else 40.0
    pairs = getattr(comp, f"ani_pairs_{path}")
    ri, qi, ani, n_total = pairs(sdb, sdb, symmetric=True,
                                 threshold=threshold)
    assert n_total == 500 * 499 // 2
    assert (ri // 128 != qi // 128).any()
    out = tmp_path / "dist.tsv"
    n = write_ani_report(out, db.names, db.names, ri, qi, ani, threshold)
    want = _want(db, config, threshold, tile=96)
    assert n == want.count("\n")
    assert out.read_text() == want
