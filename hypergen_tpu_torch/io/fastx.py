"""FASTA reading and base-code conversion (host side).

Semantics match the reference CPU path: needletail's FASTA parser +
Sequence::normalize(false) + canonical_kmers validity rules
(reference:src/sketch.rs:76-95):

  - sequence lines of a record are concatenated (line ENDINGS stripped;
    interior/trailing spaces or tabs are data and normalize to invalid,
    breaking the k-mer windows that span them — exactly what needletail's
    normalize does by mapping them to 'N');
  - a/c/g/t are uppercased; t/u/U -> T; everything that is not ACGT after
    normalization (N, gaps, IUPAC codes, junk) cannot appear in a k-mer;
  - k-mers never span record boundaries.

For the device we collapse normalization straight to 2-bit codes:
A->0 C->1 G->2 T->3, anything else -> 4 (INVALID). Records are joined with a
single INVALID separator code so one flat array per genome preserves the
no-spanning rule (same trick as the reference GPU reader, which joins
records with 'N' bytes — reference:src/fastx_reader.rs:6-29).

Gzip input is transparently supported (needletail does the same via niffler).

A C++ fast path (csrc/fastx.cpp, built with g++ at first use and loaded
via ctypes) accelerates the parse+normalize step; the numpy implementation
below is the always-available fallback and the behavioral spec.
``parser()`` says which of the two ``read_genome_packed`` uses.
"""

from __future__ import annotations

import gzip
import threading
from pathlib import Path
from typing import List, Tuple

import numpy as np

INVALID = np.uint8(4)

# raw input byte -> 2-bit base code (normalization collapsed in)
_CODE_TABLE = np.full(256, INVALID, dtype=np.uint8)
for chars, code in ((b"Aa", 0), (b"Cc", 1), (b"Gg", 2), (b"TtUu", 3)):
    for c in chars:
        _CODE_TABLE[c] = code


def seq_to_codes(seq: bytes) -> np.ndarray:
    """Normalized 2-bit codes (0..3, INVALID=4) for one record's sequence."""
    arr = np.frombuffer(bytes(seq), dtype=np.uint8)
    return _CODE_TABLE[arr]


def _open_maybe_gz(path: Path):
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_fasta_records(path) -> List[Tuple[bytes, bytes]]:
    """Parse a (possibly gzipped) FASTA file into [(header, seq_bytes)].

    Line endings are stripped; blank lines are ignored. Interior/trailing
    spaces or tabs stay in the sequence bytes and code to INVALID —
    matching needletail, whose normalize maps them to 'N' (module
    docstring). Raises ValueError on files with no '>' header.
    """
    path = Path(path)
    records: List[Tuple[bytes, bytes]] = []
    header = None
    chunks: List[bytes] = []
    with _open_maybe_gz(path) as f:
        for raw in f:
            line = raw.rstrip(b"\r\n")
            if line.startswith(b">"):
                if header is not None:
                    records.append((header, b"".join(chunks)))
                header = line[1:]
                chunks = []
            elif line:
                if header is None:
                    raise ValueError(f"{path}: sequence data before FASTA header")
                chunks.append(line)
        if header is not None:
            records.append((header, b"".join(chunks)))
    if not records:
        raise ValueError(f"{path}: no FASTA records found")
    return records


def codes_from_records(records: List[Tuple[bytes, bytes]]) -> np.ndarray:
    """Join record code arrays with one INVALID separator (no k-mer spans)."""
    parts: List[np.ndarray] = []
    sep = np.array([INVALID], dtype=np.uint8)
    for i, (_, seq) in enumerate(records):
        if i > 0:
            parts.append(sep)
        parts.append(seq_to_codes(seq))
    if not parts:
        return np.zeros(0, dtype=np.uint8)
    return np.concatenate(parts)


def read_genome_codes(path) -> np.ndarray:
    """One flat code array for a genome FASTA file (C++ fast path if built)."""
    native = _native_reader()
    if native is not None:
        try:
            return native(path)
        except Exception:
            pass  # fall back to the numpy path on any native failure
    return codes_from_records(read_fasta_records(path))


_NATIVE = None
_NATIVE_TRIED = False
_native_try_lock = threading.Lock()


def _native_reader():
    """Lazy-load the optional C++ parser (csrc/fastx.cpp)."""
    global _NATIVE, _NATIVE_TRIED
    if not _NATIVE_TRIED:
        with _native_try_lock:
            if not _NATIVE_TRIED:
                try:
                    from hypergen_tpu_torch.io import fastx_native

                    fastx_native._load()  # a build failure falls back here
                    _NATIVE = fastx_native.read_genome_codes
                except Exception:
                    _NATIVE = None
                _NATIVE_TRIED = True  # after assignment: a concurrent
                # reader must never see TRIED with the fn still unset
    return _NATIVE


import dataclasses


@dataclasses.dataclass
class PackedGenome:
    """A genome in the device input format, before bucket padding.

    packed2: uint8 [ceil(length/4)] — 2-bit codes, little-endian per byte;
      bits of invalid positions are arbitrary (validity is runs-only).
    runs: int64 [R, 2] — maximal [start, end) runs of invalid positions
      within [0, length); int64 because a genome may hold 2^31 codes or
      more (the routes cast to int32 per tile or batch, where the
      coordinates are below 2^31).
    length: genome length in codes (bases + record separators).
    """

    packed2: np.ndarray
    runs: np.ndarray
    length: int


def pack2bit(codes: np.ndarray) -> np.ndarray:
    """2-bit pack codes (low bits only): uint8 [ceil(n/4)]."""
    n = codes.shape[0]
    buf = np.zeros(-(-n // 4) * 4, dtype=np.uint8)
    buf[:n] = codes & 3
    w = buf.view(np.uint32)
    t = w & np.uint32(0x03030303)
    t |= t >> np.uint32(6)
    t |= t >> np.uint32(12)
    return np.ascontiguousarray(t.view(np.uint8)[::4])


def invalid_runs(codes: np.ndarray) -> np.ndarray:
    """Maximal [start, end) runs of invalid positions: int64 [R, 2]."""
    inv = codes >= INVALID
    flips = np.flatnonzero(np.diff(inv))
    bounds = np.empty(flips.size + 2, dtype=np.int64)
    bounds[0] = 0
    bounds[1:-1] = flips + 1
    bounds[-1] = inv.size
    first_inv = 0 if (inv.size and inv[0]) else 1
    starts = bounds[first_inv:-1:2]
    ends = bounds[first_inv + 1 :: 2]
    return np.stack([starts, ends], axis=1)


def packed_from_codes(codes: np.ndarray) -> PackedGenome:
    """Numpy fallback: flat code array -> PackedGenome."""
    return PackedGenome(pack2bit(codes), invalid_runs(codes), codes.shape[0])


def codes_from_packed(g: PackedGenome) -> np.ndarray:
    """Expand a PackedGenome back to the flat code array (rare paths only,
    e.g. routing a huge genome to the sequence-parallel sketcher)."""
    nb = g.packed2.shape[0]
    b = np.repeat(g.packed2, 4)
    shifts = np.tile(np.array([0, 2, 4, 6], np.uint8), nb)
    codes = ((b >> shifts) & np.uint8(3))[: g.length]
    codes = np.ascontiguousarray(codes)
    for s, e in g.runs:
        codes[s:e] = INVALID
    return codes


def read_genome_packed(path) -> PackedGenome:
    """Parse a genome FASTA straight into the device input format.

    Uses the fused native parse+pack (one streaming C pass, no 4x-size
    intermediate code array) when libfastx is available; numpy fallback
    otherwise. Both produce identical PackedGenomes (tests/test_native.py).
    """
    native = _native_packed_reader()
    if native is not None:
        try:
            p2, runs, n = native(path)
            return PackedGenome(p2, runs, n)
        except Exception:
            pass  # fall back to the numpy path on any native failure
    return packed_from_codes(codes_from_records(read_fasta_records(path)))


_NATIVE_PACKED = None
_NATIVE_PACKED_TRIED = False


def _native_packed_reader():
    global _NATIVE_PACKED, _NATIVE_PACKED_TRIED
    if not _NATIVE_PACKED_TRIED:
        with _native_try_lock:
            if not _NATIVE_PACKED_TRIED:
                try:
                    from hypergen_tpu_torch.io import fastx_native

                    fastx_native._load()  # a build failure falls back here
                    _NATIVE_PACKED = fastx_native.read_genome_packed
                except Exception:
                    _NATIVE_PACKED = None
                _NATIVE_PACKED_TRIED = True
    return _NATIVE_PACKED


def parser() -> str:
    """Which parser read_genome_packed uses: "native" (the C++ library,
    built on first call) or "numpy" (the fallback)."""
    return "numpy" if _native_packed_reader() is None else "native"


def get_fasta_files(path) -> List[Path]:
    """Non-recursive *.fna, *.fa, *.fasta glob in extension order
    (reference:src/utils.rs:208-221); gzipped variants also accepted."""
    path = Path(path)
    files: List[Path] = []
    for pat in ("*.fna", "*.fa", "*.fasta", "*.fna.gz", "*.fa.gz", "*.fasta.gz"):
        files.extend(sorted(path.glob(pat)))
    return files
