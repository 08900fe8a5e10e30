"""Invalid runs as int64, from the parser to the routes (the port only).

A genome of 2^31 codes or more (maize, wheat) needs run coordinates above
INT32_MAX. The port's parsers give int64 runs; ``Sketcher._tile_genome``
clips them in int64 and casts each tile's runs to int32; and
``Sketcher._prepare_batch``, the one place where runs become the int32 that
K1's postfilter takes, raises on a coordinate at or above 2^31 instead of
wrapping it. Below 2^31 the runs equal the JAX package's in value
(tolerance 0). The JAX package keeps int32 runs, so above 2^31 the expected
runs are computed here from the genome's layout.
"""

import zlib

import numpy as np
import pytest

from hypergen_tpu.io import fastx as jfastx
from hypergen_tpu_torch.io import fastx as tfastx
from hypergen_tpu_torch.io import fastx_native as tnative
from hypergen_tpu_torch.io.fastx import PackedGenome
from hypergen_tpu_torch.models.sketcher import Sketcher
from hypergen_tpu_torch.params import SketchParams
from test_torch_io import _fasta_files

G31 = 1 << 31
LINE = 1 << 16  # bases a FASTA line
BLOCK_LINES = 256  # lines a gzip member: 2^24 bases
# three records of 2^31 + 2^21 bases in all; the second boundary lies
# above 2^31
RECORDS = ((b"r1", 1 << 30), (b"r2", (1 << 30) + (1 << 20)), (b"r3", 1 << 20))
SEP1 = RECORDS[0][1]  # code position of the first record separator
SEP2 = SEP1 + 1 + RECORDS[1][1]  # of the second: 2^31 + 2^20 + 1
LENGTH = SEP2 + 1 + RECORDS[2][1]  # codes: bases + 2 separators
# N runs in code coordinates: below 2^31, across it, above it (in the
# second and the third record), and one that ends the genome
N_RUNS = ((1000, 1100), (G31 - 500, G31 + 700), (G31 + 100_000, G31 + 100_037),
          (SEP2 + 5001, SEP2 + 5101), (LENGTH - 10, LENGTH))
EXPECTED_RUNS = sorted(N_RUNS + ((SEP1, SEP1 + 1), (SEP2, SEP2 + 1)))


def _record_offsets():
    """First code position of each record."""
    starts, pos = [], 0
    for _, n in RECORDS:
        starts.append(pos)
        pos += n + 1
    return starts


def _write_big_gz(path):
    """The genome as a .fna.gz of concatenated zlib level-1 gzip members
    (one per 2^24 bases; the all-'A' member is compressed once and
    repeated), a few MB on disk."""
    pure = (b"A" * LINE + b"\n") * BLOCK_LINES

    def member(data: bytes) -> bytes:
        z = zlib.compressobj(1, zlib.DEFLATED, 31)
        return z.compress(data) + z.flush()

    pure_gz = member(pure)
    block = LINE * BLOCK_LINES
    with open(path, "wb") as fh:
        for (name, n), start in zip(RECORDS, _record_offsets()):
            fh.write(member(b">" + name + b" synthetic\n"))
            for b0 in range(0, n, block):
                m = min(block, n - b0)  # record lengths are whole lines
                lo, hi = start + b0, start + b0 + m
                hits = [(max(s, lo), min(e, hi)) for s, e in N_RUNS
                        if s < hi and e > lo]
                if m == block and not hits:
                    fh.write(pure_gz)
                    continue
                data = bytearray(pure[: m + m // LINE])
                for s, e in hits:
                    for c in range(s - lo, e - lo):
                        data[c + c // LINE] = ord("N")
                fh.write(member(bytes(data)))


@pytest.fixture(scope="module")
def big_genome(tmp_path_factory):
    path = tmp_path_factory.mktemp("runs64") / "big.fna.gz"
    _write_big_gz(path)
    p2, runs, n = tnative.read_genome_packed(path)  # no numpy fallback
    yield PackedGenome(p2, runs, n)


def test_parsers_give_int64_runs_equal_to_jax(tmp_path):
    """(a) native and numpy runs are int64 and equal the JAX package's."""
    assert tfastx.parser() == "native"
    for p in _fasta_files(tmp_path):
        want = jfastx.read_genome_packed(p).runs
        native = tfastx.read_genome_packed(p).runs
        numpy_ = tfastx.packed_from_codes(
            tfastx.codes_from_records(tfastx.read_fasta_records(p))).runs
        for got in (native, numpy_):
            assert got.dtype == np.int64 and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
    empty = tfastx.invalid_runs(np.zeros(5, np.uint8))
    assert empty.dtype == np.int64 and empty.shape == (0, 2)


def test_native_runs_above_2_31(big_genome):
    """(b) a genome of 2^31 + 2^21 bases: runs below, across and above
    2^31 and a record boundary above it, read without wrapping."""
    g = big_genome
    assert g.length == LENGTH > G31
    assert g.runs.dtype == np.int64
    assert g.runs.tolist() == [list(r) for r in EXPECTED_RUNS]
    assert g.packed2.shape == (-(-LENGTH // 4),)
    # all 'A' (code 0) where valid; the bytes around 2^31 hold N runs
    assert not g.packed2[: 1000 // 4].any()
    assert not g.packed2[(G31 + 800) // 4 : (G31 + 99_000) // 4].any()


def test_tile_runs_in_tile_coordinates(big_genome):
    """(c) each tile carries its genome's runs clipped to it, shifted to
    its own coordinates, as int32."""
    k, C, tile_chunks = 21, 1 << 17, 64
    sk = Sketcher(SketchParams(), device="cpu", chunk_positions=C)
    tiles = sk._tile_genome(big_genome, tile_chunks)
    TC = tile_chunks * C
    total_pos = LENGTH - k + 1
    assert len(tiles) == -(-total_pos // TC)
    runs = np.array(EXPECTED_RUNS, np.int64)
    for t, tile in enumerate(tiles):
        start = t * TC
        L_t = min(total_pos - start, TC) + k - 1
        want = [(max(s - start, 0), min(e - start, L_t)) for s, e in runs
                if min(e - start, L_t) > max(s - start, 0)]
        assert tile.length == L_t
        assert tile.runs.dtype == np.int32
        assert tile.runs.tolist() == [list(r) for r in want], t
    # the tiles that hold a run past 2^31 got it
    assert tiles[G31 // TC].runs.shape[0] >= 1
    assert tiles[(SEP2 + 5001) // TC].runs.shape[0] >= 1


@pytest.mark.parametrize("run,raises", [
    ((G31, G31 + 5), True),
    ((G31 - 10, G31), True),  # an end at 2^31
    ((G31 - 10, G31 - 1), False),
])
def test_prepare_batch_refuses_runs_at_2_31(run, raises):
    """(d) a run coordinate at or above 2^31 raises instead of wrapping
    in the int32 batch runs."""
    sk = Sketcher(SketchParams(), device="cpu", chunk_positions=2048)
    g = PackedGenome(np.zeros(1024, np.uint8), np.array([run], np.int64), 4096)
    if raises:
        with pytest.raises(ValueError, match="below 2\\^31"):
            sk._prepare_batch([g], 2)
    else:
        runs = sk._prepare_batch([g], 2).runs
        assert runs[0, 0].tolist() == list(run)
