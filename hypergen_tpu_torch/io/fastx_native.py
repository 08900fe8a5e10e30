"""ctypes binding to the native FASTA parser (csrc/fastx.cpp).

Builds the library with g++ on first use (``ops.kernels.build``, into
``hypergen_tpu_torch/_build/``, keyed by the source's hash) when a toolchain
is available; io.fastx falls back to the numpy parser if anything here
fails.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

_lib = None
_load_lock = threading.Lock()


def _load():
    # serialized: the sketch I/O pool (up to 16 threads) hits this on first
    # use, and unlocked it would spawn concurrent builds (the build also
    # renames atomically for cross-PROCESS safety; this lock covers the
    # in-process pool)
    global _lib
    if _lib is not None:
        return _lib
    with _load_lock:
        return _load_locked()


def _load_locked():
    global _lib
    if _lib is not None:
        return _lib
    from hypergen_tpu_torch.ops.kernels import build

    try:
        lib = build.load("fastx")
    except Exception as e:  # no toolchain / build failure -> fallback
        raise ImportError(f"native fastx build failed: {e}")
    lib.hg_read_genome_codes.restype = ctypes.c_longlong
    lib.hg_read_genome_codes.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_char_p,
        ctypes.c_int,
    ]
    lib.hg_free.restype = None
    lib.hg_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    lib.hg_read_genome_packed.restype = ctypes.c_longlong
    lib.hg_read_genome_packed.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_char_p,
        ctypes.c_int,
    ]
    _lib = lib
    return lib


def read_genome_codes(path) -> np.ndarray:
    """Parse a FASTA file to the flat code array (0..3 bases, 4 invalid)."""
    lib = _load()
    out = ctypes.POINTER(ctypes.c_uint8)()
    errbuf = ctypes.create_string_buffer(256)
    n = lib.hg_read_genome_codes(
        str(path).encode(), ctypes.byref(out), errbuf, 256
    )
    if n < 0:
        raise ValueError(f"{path}: {errbuf.value.decode()}")
    try:
        codes = np.ctypeslib.as_array(out, shape=(n,)).copy()
    finally:
        lib.hg_free(out)
    return codes


def read_genome_packed(path):
    """Fused native parse+pack: (packed2 u8 [ceil(n/4)], runs i64 [R, 2], n).

    One streaming C pass over the FASTA bytes — no intermediate 4x-size
    code array (csrc/fastx.cpp hg_read_genome_packed). Validity of
    positions comes solely from the run list; packed padding bits are
    arbitrary (code & 3).
    """
    lib = _load()
    packed_p = ctypes.POINTER(ctypes.c_uint8)()
    runs_p = ctypes.POINTER(ctypes.c_int64)()
    n_runs = ctypes.c_longlong(0)
    errbuf = ctypes.create_string_buffer(256)
    n = lib.hg_read_genome_packed(
        str(path).encode(), ctypes.byref(packed_p), ctypes.byref(runs_p),
        ctypes.byref(n_runs), errbuf, 256,
    )
    if n < 0:
        raise ValueError(f"{path}: {errbuf.value.decode()}")
    try:
        nb = -(-n // 4)
        packed2 = (
            np.ctypeslib.as_array(packed_p, shape=(nb,)).copy()
            if nb else np.zeros(0, np.uint8)
        )
        runs = (
            np.ctypeslib.as_array(runs_p, shape=(n_runs.value, 2)).copy()
            if n_runs.value else np.zeros((0, 2), np.int64)
        )
    finally:
        if packed_p:
            lib.hg_free(packed_p)
        if runs_p:
            lib.hg_free(ctypes.cast(runs_p, ctypes.POINTER(ctypes.c_uint8)))
    return packed2, runs, int(n)

