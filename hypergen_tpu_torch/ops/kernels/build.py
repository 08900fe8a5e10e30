"""Build the sources under ``csrc/`` and load them with ctypes.

Each source has a plain C entry point, so it builds in seconds without
PyTorch's headers: a CUDA file (``<name>.cu``) with ``nvcc`` for sm_90a, a
host file (``<name>.cpp``: the FASTA parser, the TSV row formatter) with
``g++``. The library is
built at first use into ``hypergen_tpu_torch/_build/``, under a name keyed
by a hash of the source and the flags, so an edited source always rebuilds.
Nothing is built or loaded when a module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
# -split-compile=0: optimise the kernels on all host cores (8-10 s instead
# of 16 s for hash_kernel.cu)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-split-compile=0",
)
# no -march=native: the build directory is keyed by source, not by host
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-Wall")
GXX_LIBS = ("-lz",)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _gxx() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found: the native host sources need it")


def _source(name: str) -> Path:
    for suffix in (".cu", ".cpp"):
        src = CSRC_DIR / f"{name}{suffix}"
        if src.exists():
            return src
    raise FileNotFoundError(f"no csrc/{name}.cu or csrc/{name}.cpp")


def _flags(src: Path):
    return NVCC_FLAGS if src.suffix == ".cu" else GXX_FLAGS + GXX_LIBS


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` or ``.cpp`` lives once built."""
    src = _source(name)
    flags = " ".join(_flags(src)).encode()
    digest = hashlib.sha256(src.read_bytes() + flags).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` or ``.cpp`` unless its library exists;
    return its path.

    The compiler writes to a temporary name that is renamed into place, so
    a concurrent or interrupted build never leaves a half-written library.
    """
    out = library_path(name)
    if out.exists():
        return out
    src = _source(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    if src.suffix == ".cu":
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
    else:
        cmd = [_gxx(), *GXX_FLAGS, "-o", tmp, str(src), *GXX_LIBS]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(
                f"{Path(cmd[0]).name} failed for {src.name} "
                f"({res.returncode}):\n{res.stdout}{res.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build if needed, then load ``csrc/<name>`` (once per process)."""
    return ctypes.CDLL(str(build(name)))
