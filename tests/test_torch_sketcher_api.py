"""The port's Sketcher library API against the JAX package's.

``sketch_codes(codes)`` (flat codes, routed as ``sketch_files`` routes a
genome), ``sketch_file(path)`` and the ``progress`` / ``io_threads`` /
``read_ahead`` keywords of ``sketch_files``, each bit- or byte-identical to
the JAX ``Sketcher`` on the CPU (tolerance 0).
"""

import dataclasses

import numpy as np
import pytest

from hypergen_tpu import params as jax_params
from hypergen_tpu.io import sketch_db as jdb
from hypergen_tpu.models.sketcher import Sketcher as JaxSketcher
from hypergen_tpu_torch.io import sketch_db as tdb
from hypergen_tpu_torch.io.fastx import INVALID
from hypergen_tpu_torch.models import sketcher as ts
from hypergen_tpu_torch.params import SketchParams

HV_D = 256
C = 2048


def _jax(p, **kw):
    """The JAX package's Sketcher, with SketchParams equal to the port's p."""
    return JaxSketcher(jax_params.SketchParams(**dataclasses.asdict(p)),
                       chunk_positions=C, batch=2, **kw)


def _port(p, **kw):
    return ts.Sketcher(p, device="cpu", chunk_positions=C, batch=2, **kw)


def _codes(rng, bp, n_runs=0):
    codes = rng.integers(0, 4, size=bp).astype(np.uint8)
    for _ in range(n_runs):
        s = int(rng.integers(0, max(bp - 60, 1)))
        codes[s : s + int(rng.integers(1, 50))] = INVALID
    return codes


# (label, length, N runs, scaled, seqpar_min_chunks)
CODES_CASES = [
    ("n_runs", 30_000, 12, 40, 512),
    ("shorter_than_k", 15, 0, 40, 512),
    ("empty", 0, 0, 40, 512),
    ("scaled1", 5_000, 3, 1, 512),
    # 50,000 codes = a 32-chunk bucket: at 16 the port tiles it
    ("huge_tiled", 50_000, 8, 40, 16),
]


@pytest.mark.parametrize("label,bp,n_runs,scaled,min_chunks", CODES_CASES,
                         ids=[c[0] for c in CODES_CASES])
def test_sketch_codes_matches_jax(monkeypatch, label, bp, n_runs, scaled,
                                  min_chunks):
    rng = np.random.default_rng(41 + bp)
    codes = _codes(rng, bp, n_runs)
    p = SketchParams(hv_d=HV_D, scaled=scaled)
    sk = _port(p, seqpar_min_chunks=min_chunks)
    routes = []
    monkeypatch.setattr(sk, "sketch_packed_tiled", lambda g, orig=(
        sk.sketch_packed_tiled): routes.append("tiled") or orig(g))
    got = sk.sketch_codes(codes)
    want = _jax(p).sketch_codes(codes)
    assert routes == (["tiled"] if label == "huge_tiled" else [])
    assert got["hv"].dtype == np.int16 and got["hv"].shape == (HV_D,)
    np.testing.assert_array_equal(got["hv"], np.asarray(want["hv"]))
    assert got["norm2"] == int(want["norm2"])
    assert got["n_hashes"] == int(want["n_hashes"])
    if bp < p.ksize:
        assert got["n_hashes"] == 0 and not got["hv"].any()
    else:
        assert got["n_hashes"] > 0


def _write(path, codes):
    seq = np.frombuffer(b"ACGT", np.uint8)[np.where(codes < 4, codes, 0)]
    seq[codes >= 4] = ord("N")
    path.write_bytes(b">g one\n" + seq.tobytes() + b"\n")
    return path


@pytest.mark.parametrize("bp,min_chunks", [(12_000, 512), (50_000, 16)],
                         ids=["batch", "huge_tiled"])
def test_sketch_file_matches_jax(tmp_path, bp, min_chunks):
    rng = np.random.default_rng(51)
    f = _write(tmp_path / "g.fna", _codes(rng, bp, 6))
    p = SketchParams(hv_d=HV_D, scaled=40)
    got = _port(p, seqpar_min_chunks=min_chunks).sketch_file(f)
    want = _jax(p).sketch_file(f)
    for field in dataclasses.fields(want):
        a, b = getattr(got, field.name), getattr(want, field.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, field.name
    assert tdb.FileSketch is not jdb.FileSketch


def test_sketch_files_keywords_keep_bytes(tmp_path):
    """progress=False, one I/O thread and a read-ahead of one file give the
    defaults' bytes and the JAX package's, in input order."""
    rng = np.random.default_rng(61)
    d = tmp_path / "g"
    d.mkdir()
    # two buckets (2 and 8 chunks), so the read-ahead window sees both
    paths = [_write(d / f"g{i}.fna", _codes(rng, bp, 3))
             for i, bp in enumerate([3000, 12_000, 3500, 14_000, 2500])]
    p = SketchParams(hv_d=HV_D, scaled=40)
    out = {}
    for label, kw in (("default", {}),
                      ("keywords", dict(progress=False, io_threads=1,
                                        read_ahead=1))):
        tdb.dump_sketch(_port(p).sketch_files(paths, **kw),
                        tmp_path / f"{label}.sketch")
        out[label] = (tmp_path / f"{label}.sketch").read_bytes()
    jdb.dump_sketch(_jax(p).sketch_files(paths, progress=False),
                    tmp_path / "jax.sketch")
    assert out["keywords"] == out["default"] == (
        tmp_path / "jax.sketch").read_bytes()
