"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (``csrc/*.cuh`` and
``csrc/ext/*.cuh`` are headers they share).  The first call of
``load_library(name)`` compiles it for Hopper (``sm_90a``) into
``ops/build/<name>-<hash>.so``, keyed by a hash of the sources and flags, so
an edited source is rebuilt and an unchanged one is reused.  Building needs
the CUDA toolkit (``nvcc`` on ``PATH``, or under ``CUDA_HOME``) and happens
only when a kernel is first launched, never at import.

A family written outside the package brings its own ext header (a struct
deriving from ``NoExt``, ``csrc/fused_ext.cuh``): ``load_library(name,
header, struct)`` builds the rollout kernels with that struct as
``EXT_USER`` and no other ext (``csrc/exts.cuh``), into
``ops/build/<name>-user-<hash>.so``.  That hash also covers the header's
path and struct and the bytes of every file in the header's directory, so
an edited header is rebuilt (in the next process: a library is loaded once
a process) and the built-in library is never replaced.
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
# The file that csrc/exts.cuh includes for a user ext; the build writes it
# into an include directory of its own.
USER_SHIM = "minigrid_user_ext.cuh"

# name, or (name, header as given, struct) for a user ext -> its library,
# loaded once a process.
_LIBS: dict[object, ctypes.CDLL] = {}
# name (``name[struct]`` for a user ext) -> (seconds the build took, nvcc's
# output including ptxas' register and spill report); absent when the
# library was already built.
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


def _user_header(header, struct: str | None) -> Path:
    """The header's absolute path, after checking it and the struct name."""
    path = Path(header).resolve()
    if not path.is_file():
        raise FileNotFoundError(f"ext header {path} does not exist")
    if any(c in str(path) for c in '"\\\n'):
        raise ValueError(f"ext header path {path} holds a quote, backslash or newline")
    if not struct or not all(part.isidentifier() for part in struct.split("::")):
        raise ValueError(f"kernel_struct must name a C++ struct, got {struct!r}")
    return path


def _header_files(path: Path) -> list[Path]:
    return sorted(p for p in path.parent.iterdir() if p.is_file())


def library_path(name: str, header=None, struct: str | None = None) -> Path:
    """Where ``load_library`` keeps ``csrc/<name>.cu``'s library: a hash of
    every file of ``csrc/`` and the flags, and for a user ext (``header``
    and ``struct``) of the header's path, the struct and every file in the
    header's directory.  Computing it needs no ``nvcc``."""
    digest = hashlib.sha256()
    for path in sorted(p for p in CSRC.rglob("*") if p.is_file()):
        digest.update(str(path.relative_to(CSRC)).encode() + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    if header is None:
        return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    path = _user_header(header, struct)
    digest.update(f"\0{path}\0{struct}\0".encode())
    for f in _header_files(path):
        digest.update(f.name.encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"{name}-user-{digest.hexdigest()[:16]}.so"


def _compile(src: Path, out: Path, flags: tuple[str, ...], info_key: str) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *flags, "-o", tmp, str(src)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} ({info_key}):\n{proc.stdout}{proc.stderr}")
        BUILD_INFO[info_key] = (time.perf_counter() - t0, proc.stdout + proc.stderr)
        os.replace(tmp, out)  # atomic: no process loads a half-written library
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_library(name: str, header=None, struct: str | None = None) -> ctypes.CDLL:
    """The loaded ``csrc/<name>.cu`` library, built on first use; with
    ``header`` and ``struct``, the one built with that user ext as
    ``EXT_USER``.  A library is loaded once a process, as a Python module is
    imported once, so that a launch makes no file-system call;
    ``library_path`` keys the built files by content, so an edited header
    is rebuilt in the next process, never served from a stale build.  A
    failed build raises ``RuntimeError`` with ``nvcc``'s output."""
    key = name if header is None else (name, str(header), struct)
    if key not in _LIBS:
        src = CSRC / f"{name}.cu"
        if header is None:
            out = library_path(name)
            if not out.exists():
                _compile(src, out, NVCC_FLAGS, name)
        else:
            path = _user_header(header, struct)
            out = library_path(name, path, struct)
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                with tempfile.TemporaryDirectory(dir=BUILD_DIR) as shim_dir:
                    Path(shim_dir, USER_SHIM).write_text(f'#include "{path}"\n')
                    flags = (*NVCC_FLAGS, "-I", shim_dir, "-I", str(CSRC), f"-DMINIGRID_USER_EXT={struct}")
                    _compile(src, out, flags, f"{name}[{struct}]")
        _LIBS[key] = ctypes.CDLL(str(out))
    return _LIBS[key]
