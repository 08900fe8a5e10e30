"""The port's own copies of the JAX package's host modules, against them.

``hypergen_tpu_torch`` takes nothing from ``hypergen_tpu``: ``params``,
``io.fastx`` (native and numpy parser), ``io.bitpack`` and ``io.sketch_db``
are copies. These tests hold each copy to its original on the same inputs
(the same constants, codes, runs and bytes; tolerance 0), and scan the
port's sources for any import of the JAX package or of jax.
"""

import ast
import dataclasses
import gzip
from pathlib import Path

import numpy as np
import pytest

from hypergen_tpu import params as jp
from hypergen_tpu.io import bitpack as jbitpack
from hypergen_tpu.io import fastx as jfastx
from hypergen_tpu.io import sketch_db as jdb
from hypergen_tpu_torch import params as tp
from hypergen_tpu_torch.io import bitpack as tbitpack
from hypergen_tpu_torch.io import fastx as tfastx
from hypergen_tpu_torch.io import fastx_native as tnative
from hypergen_tpu_torch.io import sketch_db as tdb
from hypergen_tpu_torch.ops.kernels import build

ROOT = Path(__file__).resolve().parents[1]


def test_params_match():
    names = [n for n in dir(jp) if n.isupper()]
    assert names and names == [n for n in dir(tp) if n.isupper()]
    for n in names:
        assert getattr(tp, n) == getattr(jp, n), n
    for cls in ("SketchParams", "DistParams"):
        a, b = getattr(tp, cls)(), getattr(jp, cls)()
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        if cls == "SketchParams":
            # the one deliberate difference: the port's default device
            assert (a.pop("device"), b.pop("device")) == ("cuda", "tpu")
        assert a == b
    for scaled in (1, 2, 1500, 10**6):
        assert tp.fracminhash_threshold(scaled) == jp.fracminhash_threshold(
            scaled)
        assert (tp.SketchParams(scaled=scaled).threshold
                == jp.SketchParams(scaled=scaled).threshold)


def _fasta_files(d: Path):
    """Files that exercise the parser: lower case, N runs, IUPAC codes, U,
    spaces, CRLF, blank lines, several records, gzip, an empty record."""
    rng = np.random.default_rng(9)
    seq = np.frombuffer(b"ACGTacgtNnRYuU", np.uint8)[
        rng.integers(0, 14, size=50_000)].tobytes()
    files = {
        "plain.fna": b">a one\n" + seq[:30_000] + b"\n",
        "records.fa": (b">r1\n" + seq[:700] + b"\n\n>r2 x\r\n" + seq[700:990]
                       + b"\r\n" + seq[990:5000] + b"\n>empty\n>r3\n"
                       + seq[5000:5003] + b"\n"),
        "spaces.fasta": b">s\nACGT ACGT\tAC\nGGTT  \n",
        "short.fna": b">t\nAC\n",
    }
    paths = []
    for name, data in files.items():
        p = d / name
        p.write_bytes(data)
        paths.append(p)
    gz = d / "zipped.fna.gz"
    with gzip.open(gz, "wb") as fh:
        fh.write(files["plain.fna"] + b">b\n" + seq[30_000:] + b"\n")
    return paths + [gz]


def _same_packed(a, b):
    np.testing.assert_array_equal(a.packed2, b.packed2)
    np.testing.assert_array_equal(a.runs, b.runs)
    assert a.length == b.length


def test_native_parser_matches_jax(tmp_path):
    assert tfastx.parser() == "native"  # built from csrc/fastx.cpp
    for p in _fasta_files(tmp_path):
        _same_packed(tfastx.read_genome_packed(p), jfastx.read_genome_packed(p))
        np.testing.assert_array_equal(
            tnative.read_genome_codes(p), jfastx.read_genome_codes(p))


def test_numpy_parser_matches_jax(tmp_path):
    for p in _fasta_files(tmp_path):
        codes = tfastx.codes_from_records(tfastx.read_fasta_records(p))
        want = jfastx.codes_from_records(jfastx.read_fasta_records(p))
        np.testing.assert_array_equal(codes, want)
        g = tfastx.packed_from_codes(codes)
        _same_packed(g, jfastx.packed_from_codes(want))
        _same_packed(g, tfastx.read_genome_packed(p))  # numpy == native
        np.testing.assert_array_equal(tfastx.codes_from_packed(g), codes)
        np.testing.assert_array_equal(
            tfastx.codes_from_packed(g), jfastx.codes_from_packed(g))
    assert [p.name for p in tfastx.get_fasta_files(tmp_path)] == [
        p.name for p in jfastx.get_fasta_files(tmp_path)]


def test_parser_falls_back_to_numpy(tmp_path, monkeypatch):
    """Without a compiler the numpy parser takes over, and parser() says
    so."""
    def no_build(name):
        raise RuntimeError("no g++")

    monkeypatch.setattr(build, "load", no_build)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tfastx, "_NATIVE_PACKED", None)
    monkeypatch.setattr(tfastx, "_NATIVE_PACKED_TRIED", False)
    assert tfastx.parser() == "numpy"
    p = _fasta_files(tmp_path)[1]
    _same_packed(tfastx.read_genome_packed(p), jfastx.read_genome_packed(p))


def test_native_library_keyed_by_source():
    lib = build.library_path("fastx")
    assert lib.parent == build.BUILD_DIR and lib.name.startswith("libfastx_")
    assert build.library_path("hash_kernel").name.startswith("libhash_kernel_")
    assert "-march=native" not in build.GXX_FLAGS


@pytest.mark.parametrize("amp", [1, 40, 3000, 32767])
def test_bitpack_matches_jax(amp):
    rng = np.random.default_rng(amp)
    hv = rng.integers(-amp, amp + 1, size=4096).astype(np.int16)
    packed, bits = tbitpack.compress_hv(hv)
    assert (packed, bits) == jbitpack.compress_hv(hv)
    np.testing.assert_array_equal(tbitpack.unpack_hv(packed, bits, 4096), hv)


def _sketches(mod, n=3):
    rng = np.random.default_rng(n)
    out = []
    for i in range(n):
        hv = rng.integers(-300, 300, size=1024).astype(np.int16)
        norm2 = int((hv.astype(np.int64) ** 2).sum())
        out.append(mod.FileSketch.from_dense(
            hv, norm2, f"genomes/g{i}.fna", 21, 1500, True, 123))
    return out


def test_sketch_file_bytes_match_jax(tmp_path):
    size = tdb.dump_sketch(_sketches(tdb), tmp_path / "t.sketch")
    jdb.dump_sketch(_sketches(jdb), tmp_path / "j.sketch")
    a = (tmp_path / "t.sketch").read_bytes()
    assert size == len(a) and a == (tmp_path / "j.sketch").read_bytes()
    db = tdb.sketches_to_db(tdb.load_sketch(tmp_path / "j.sketch"))
    jd = jdb.sketches_to_db(jdb.load_sketch(tmp_path / "t.sketch"))
    np.testing.assert_array_equal(db.hvs, jd.hvs)
    np.testing.assert_array_equal(db.norms, jd.norms)
    assert db.names == jd.names


def test_hgdb_bytes_match_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # names resolve against the cwd
    tdb.dump_sharded_db(tdb.sketches_to_db(_sketches(tdb, 5)), "t.hgdb", 2)
    jdb.dump_sharded_db(jdb.sketches_to_db(_sketches(jdb, 5)), "j.hgdb", 2)
    files = sorted(p.name for p in Path("j.hgdb").iterdir())
    assert files == sorted(p.name for p in Path("t.hgdb").iterdir())
    for name in files:
        assert (Path("t.hgdb") / name).read_bytes() == (
            Path("j.hgdb") / name).read_bytes()
    a, b = tdb.load_sharded_db("j.hgdb"), jdb.load_sharded_db("t.hgdb")
    np.testing.assert_array_equal(a.hvs, b.hvs)
    assert a.names == b.names


def _port_sources():
    return sorted((ROOT / "hypergen_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "hypergen_tpu")


def test_port_imports_nothing_of_the_jax_package():
    """No module of the port, and not chip_smoke.py, imports jax or
    anything of hypergen_tpu (hypergen_tpu_torch is the port itself)."""
    sources = _port_sources()
    assert len(sources) > 20
    bad = []
    for path in sources:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            elif (isinstance(node, ast.Call)
                  and getattr(node.func, "id", "") == "__import__"):
                names = [getattr(a, "value", "") for a in node.args[:1]]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                    for n in names if isinstance(n, str) and _forbidden(n)]
    assert not bad, bad


def test_import_scan_catches_the_jax_package():
    assert _forbidden("hypergen_tpu.io.fastx")
    assert _forbidden("hypergen_tpu")
    assert _forbidden("jax.numpy")
    assert not _forbidden("hypergen_tpu_torch.io.fastx")
    assert not _forbidden("torch")
