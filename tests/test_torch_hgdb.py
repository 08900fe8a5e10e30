"""The PyTorch port's CLI against the JAX package's on the CPU, on the
database path: `.hgdb` output with --shards and --resume, `dist` on `.hgdb`,
`search` and `hist`. Tolerance: every file and every line of stdout
byte-identical."""

import shutil

import numpy as np
import pytest

from hypergen_tpu.cli import main as jax_main
from hypergen_tpu_torch.cli import main as torch_main

MAINS = {"jax": jax_main, "torch": torch_main}


def _write_genomes(d, first, last):
    """Related genomes g{first}..g{last - 1} of 30 kb (a base with 1-6 %
    point changes; g2 has N runs, g3 two records)."""
    rng = np.random.default_rng(11)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = rng.choice(acgt, size=30000)
    for i in range(last):
        s = base.copy()
        flip = rng.random(s.size) < 0.01 * (i + 1)
        s[flip] = rng.choice(acgt, size=int(flip.sum()))
        if i < first:
            continue
        seq = s.tobytes()
        if i == 2:
            seq = seq[:5000] + b"N" * 120 + seq[5120:]
        body = (b">a\n" + seq[:12000] + b"\n>b\n" + seq[12000:] + b"\n"
                if i == 3 else b">g%d\n" % i + seq + b"\n")
        (d / f"g{i}.fna").write_bytes(body)


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both CLIs through: sketch of 3 genomes into an .hgdb of 3 shards,
    a resume after 2 more genomes arrive, a resume with nothing left, and
    a .sketch of all 5. Returns (work dir, the .hgdb files after each
    step, per CLI)."""
    root = tmp_path_factory.mktemp("torch_hgdb")
    genomes = root / "genomes"
    genomes.mkdir()
    _write_genomes(genomes, 0, 3)
    steps = {name: [] for name in MAINS}
    for name, main in MAINS.items():
        main(["sketch", "-p", str(genomes), "-o", str(root / f"{name}.hgdb"),
              "--shards", "3", "-D", "cpu"])
        steps[name].append(_files(root / f"{name}.hgdb"))
    _write_genomes(genomes, 3, 5)
    for _ in range(2):  # the second resume finds nothing left
        for name, main in MAINS.items():
            main(["sketch", "-p", str(genomes), "-o",
                  str(root / f"{name}.hgdb"), "--resume", "-D", "cpu"])
            steps[name].append(_files(root / f"{name}.hgdb"))
    for name, main in MAINS.items():
        main(["sketch", "-p", str(genomes), "-o",
              str(root / f"{name}.sketch"), "-D", "cpu"])
    return root, steps


@pytest.mark.parametrize("step", [0, 1, 2])
def test_hgdb_files_equal(run, step):
    """Every file of the .hgdb after the first sketch (3 shards), after a
    resume (one shard appended, the others untouched) and after a resume
    with nothing left (nothing touched)."""
    _, steps = run
    got, want = steps["torch"][step], steps["jax"][step]
    assert got == want
    n_shards = {0: 3, 1: 4, 2: 4}[step]
    assert len(want) == 1 + 2 * n_shards
    if step:
        before = steps["torch"][step - 1]
        assert all(got[f] == before[f] for f in before if f.endswith(".npy"))
    if step == 2:
        assert got == steps["torch"][1]


@pytest.mark.parametrize("ani", ["85", "0"])
def test_dist_on_hgdb_bytes_equal(run, ani):
    root, _ = run
    for name, main in MAINS.items():
        db = str(root / f"{name}.hgdb")
        main(["dist", "-r", db, "-q", db, "-o",
              str(root / f"{name}_{ani}.tsv"), "-a", ani, "-D", "cpu"])
    want = (root / f"jax_{ani}.tsv").read_bytes()
    assert (root / f"torch_{ani}.tsv").read_bytes() == want
    assert len(want.splitlines()) == 10


@pytest.mark.parametrize("kind", ["sketch", "hgdb"])
def test_search_bytes_equal(run, kind):
    root, _ = run
    for name, main in MAINS.items():
        db = str(root / f"{name}.{kind}")
        main(["search", "-r", db, "-q", db, "-o",
              str(root / f"{name}_search_{kind}.tsv"), "--top_k", "3",
              "-a", "80", "-D", "cpu"])
    want = (root / f"jax_search_{kind}.tsv").read_bytes()
    assert (root / f"torch_search_{kind}.tsv").read_bytes() == want
    rows = [r.split("\t") for r in want.decode().splitlines()]
    assert len(rows) == 15
    assert all(r[0] == r[1] and r[2] == "100.000" for r in rows[::3])


@pytest.mark.parametrize("kind", ["sketch", "hgdb"])
def test_hist_stdout_equal(run, kind, capsys):
    root, _ = run
    out = {}
    for name, main in MAINS.items():
        capsys.readouterr()
        main(["hist", "-r", str(root / f"{name}.{kind}")])
        out[name] = capsys.readouterr().out
    assert out["torch"] == out["jax"]
    counts = [int(line.split("\t")[1]) for line in out["jax"].splitlines()]
    assert sum(counts) == 5 * 4096


def test_resume_with_other_params_exits(run, tmp_path):
    """A resume whose sketch parameters differ from the DB's exits non-zero
    in both CLIs and leaves the DB as it was."""
    root, steps = run
    for name, main in MAINS.items():
        db = tmp_path / f"{name}.hgdb"
        shutil.copytree(root / f"{name}.hgdb", db)
        with pytest.raises(SystemExit) as exc:
            main(["sketch", "-p", str(root / "genomes"), "-o", str(db),
                  "--resume", "-s", "1000", "-D", "cpu"])
        assert exc.value.code not in (0, None)
        assert _files(db) == steps[name][2]


@pytest.mark.parametrize("cmd", ["search", "dist"])
def test_cuda_without_a_card_exits(run, tmp_path, cmd):
    """-D cuda (the default) on a machine without a card exits non-zero and
    writes nothing: no fall back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    root, _ = run
    db = str(root / "torch.hgdb")
    with pytest.raises(SystemExit) as exc:
        torch_main([cmd, "-r", db, "-q", db, "-o", str(tmp_path / "out")])
    assert exc.value.code not in (0, None)
    assert not (tmp_path / "out").exists()
