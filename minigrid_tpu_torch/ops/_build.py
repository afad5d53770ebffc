"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface.  The first call of
``load_library(name)`` compiles it for Hopper (``sm_90a``) into
``ops/build/<name>-<hash>.so``, keyed by a hash of the sources and flags, so
an edited source is rebuilt and an unchanged one is reused.  Building needs
the CUDA toolkit (``nvcc`` on ``PATH``, or under ``CUDA_HOME``) and happens
only when a kernel is first launched, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
# name -> (seconds the build took, nvcc's output including ptxas' register
# and spill report); absent when the library was already built.
BUILD_INFO: dict[str, tuple[float, str]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put the CUDA toolkit on PATH or set CUDA_HOME")
    return str(path)


def load_library(name: str) -> ctypes.CDLL:
    """The loaded ``csrc/<name>.cu`` library, built on first use."""
    if name in _LIBS:
        return _LIBS[name]
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256()
    for path in sorted(CSRC.iterdir()):
        digest.update(path.name.encode() + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)], capture_output=True, text=True
            )
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stdout}{proc.stderr}")
            BUILD_INFO[name] = (time.perf_counter() - t0, proc.stdout + proc.stderr)
            os.replace(tmp, out)  # atomic: no process loads a half-written library
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(out))
    _LIBS[name] = lib
    return lib
