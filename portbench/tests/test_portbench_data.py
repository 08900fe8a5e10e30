"""The generators are deterministic by seed and give the stated sizes."""

import copy

import numpy as np
import torch

from portbench.harness import data
from portbench.tests.small import SPEC, small

K = 21


def test_pool_sizes_are_the_configurations():
    config = SPEC.config("gtdb_r220_build")
    sizes = data.pool_sizes(config)
    a = config["assumed"]
    bp = np.array([s[0] for s in sizes])
    assert len(sizes) == config["genomes"] == 128
    assert bp.min() >= a["genome_bp"]["min"] and bp.max() <= a["genome_bp"]["max"]
    assert abs(np.median(bp) - a["genome_bp"]["median"]) < 0.02 * a["genome_bp"]["median"]
    assert 0.45e9 < bp.sum() < 0.55e9  # "about 0.5 Gbp"
    assert all(1 <= s[1] <= 300 and 0 <= s[2] <= 20 for s in sizes)
    assert sum(s[3] for s in sizes) == 13  # one genome in ten soft-masked


def test_pool_is_deterministic_and_sized_alike_for_every_seed():
    _, config, _ = small("gtdb_r220_build.files_mix")
    a = data.make_pool(config, 7, "cpu")
    b = data.make_pool(config, 7, "cpu")
    c = data.make_pool(config, 2**33 + 7, "cpu")
    assert all(np.array_equal(x.codes(), y.codes()) for x, y in zip(a, b))
    assert [g.bases for g in a] == [g.bases for g in c]
    assert any(not np.array_equal(x.codes(), y.codes()) for x, y in zip(a, c))
    for g, (bp, n_contigs, n_runs, masked) in zip(a, data.pool_sizes(config)):
        assert g.bases == bp
        assert min(x.size for x in g.contigs) >= config["assumed"]["contigs"]["min_bp"]
        assert bool(g.masked) == masked


def test_fasta_holds_the_genome(tmp_path):
    _, config, _ = small("gtdb_r220_build.files_mix")
    genomes = data.make_pool(config, 11, "cpu")
    for g, path in zip(genomes, data.write_pool(genomes, tmp_path, 80)):
        text = path.read_bytes().split(b"\n")
        heads = [x for x in text if x.startswith(b">")]
        seq = b"".join(x for x in text if x and not x.startswith(b">"))
        assert len(heads) == len(g.contigs)
        assert max(len(x) for x in text) <= 80 or text[0].startswith(b">")
        want = np.concatenate(g.contigs)
        got = np.frombuffer(seq.upper(), np.uint8)
        assert np.array_equal(got == ord("N"), want == data.INVALID)
        assert np.array_equal(np.frombuffer(b"ACGT", np.uint8)[want[want < 4]],
                              got[want < 4])
        assert bool(g.masked) == any(c in seq for c in b"acgt")


def test_database_is_deterministic_and_sized(tmp_path):
    _, config, mix = small("gtdb_r220_db.search_4096")
    db, q = data.make_database(config, mix, 5, "cpu")
    db2, q2 = data.make_database(config, mix, 5, "cpu")
    assert np.array_equal(db.hvs, db2.hvs) and np.array_equal(q.hvs, q2.hvs)
    D = config["sketch"]["hv_d"]
    assert db.hvs.shape == (config["rows"], D) and db.hvs.dtype == np.int16
    assert q.hvs.shape == (mix["queries"], D)
    assert np.array_equal(db.norms, data.norms_i32(torch.from_numpy(db.hvs)).numpy())
    rows = {n: i for i, n in enumerate(db.names)}
    for j in range(mix["self_queries"]):
        assert np.array_equal(q.hvs[j], db.hvs[rows[q.names[j]]])
    full = copy.deepcopy(SPEC.config("gtdb_r220_db"))
    assert full["rows"] % full["family"] == 0


def test_hgdb_round_trips_and_the_port_reads_it(tmp_path):
    from hypergen_tpu_torch.io.sketch_db import load_sharded_db

    _, config, mix = small("gtdb_r220_db.search_4096")
    db, _ = data.make_database(config, mix, 9, "cpu")
    data.write_hgdb(db, tmp_path / "x.hgdb", config["sketch"], 8)
    back = data.read_hgdb(tmp_path / "x.hgdb")
    port = load_sharded_db(tmp_path / "x.hgdb")
    for got in (back, port):
        assert list(got.names) == db.names
        assert np.array_equal(got.hvs, db.hvs)
        assert np.array_equal(got.norms, db.norms)
