"""The PyTorch port's CLI against the JAX package's on the CPU: `sketch`
and `dist` outputs must be byte-identical. Also: the port imports and
starts with jax blocked."""

import gzip
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from hypergen_tpu.cli import main as jax_main
from hypergen_tpu_torch.cli import main as torch_main

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def genome_dir(tmp_path_factory):
    """Five related genomes: mixed case, N runs, two records, one gzip."""
    d = tmp_path_factory.mktemp("torch_cli") / "genomes"
    d.mkdir()
    rng = np.random.default_rng(7)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = rng.choice(acgt, size=30000)
    for i in range(5):
        s = base.copy()
        flip = rng.random(s.size) < 0.01 * i
        s[flip] = rng.choice(acgt, size=int(flip.sum()))
        seq = bytearray(s.tobytes())
        if i == 1:
            seq[1000:3000] = bytes(seq[1000:3000]).lower()
        if i == 2:
            seq[5000:5100] = b"N" * 100
            seq[9000:9003] = b"NNN"
        seq = bytes(seq)
        if i == 3:
            body = b">a\n" + seq[:12000] + b"\n>b\n" + seq[12000:] + b"\n"
        else:
            body = b">g%d desc\n" % i + seq + b"\n"
        if i == 4:
            with gzip.open(d / f"g{i}.fna.gz", "wb") as fh:
                fh.write(body)
        else:
            (d / f"g{i}.fna").write_bytes(body)
    return d


@pytest.fixture(scope="module")
def sketches(genome_dir):
    out = genome_dir.parent
    jax_main(["sketch", "-p", str(genome_dir), "-o", str(out / "jax.sketch"),
              "-D", "cpu"])
    torch_main(["sketch", "-p", str(genome_dir),
                "-o", str(out / "torch.sketch"), "-D", "cpu"])
    return out / "jax.sketch", out / "torch.sketch"


def test_sketch_bytes_equal(sketches):
    a, b = sketches
    assert a.read_bytes() == b.read_bytes()
    assert a.stat().st_size > 0


@pytest.mark.parametrize("ani", ["85", "0"])
def test_dist_tsv_bytes_equal(sketches, ani):
    js, ts = sketches
    out = js.parent
    jax_main(["dist", "-r", str(js), "-q", str(js),
              "-o", str(out / f"jax_{ani}.tsv"), "-a", ani, "-D", "cpu"])
    torch_main(["dist", "-r", str(ts), "-q", str(ts),
                "-o", str(out / f"torch_{ani}.tsv"), "-a", ani, "-D", "cpu"])
    want = (out / f"jax_{ani}.tsv").read_bytes()
    assert (out / f"torch_{ani}.tsv").read_bytes() == want
    assert len(want.splitlines()) == 10  # every pair of 5 related genomes


def test_dist_asymmetric_bytes_equal(sketches, genome_dir):
    js, ts = sketches
    out = js.parent
    jax_main(["dist", "-r", str(js), "-q", str(ts),
              "-o", str(out / "jax_rq.tsv"), "-D", "cpu"])
    torch_main(["dist", "-r", str(ts), "-q", str(js),
                "-o", str(out / "torch_rq.tsv"), "-D", "cpu"])
    want = (out / "jax_rq.tsv").read_bytes()
    assert (out / "torch_rq.tsv").read_bytes() == want
    assert len(want.splitlines()) == 25


def test_port_imports_and_starts_without_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "import hypergen_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert not any(n == 'jax' or n.startswith('jax.')\n"
        "               for n, v in sys.modules.items() if v is not None)\n"
        "from hypergen_tpu_torch.cli import main\n"
        "main(['--help'])\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "sketch" in res.stdout and "dist" in res.stdout
