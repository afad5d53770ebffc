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

The rollout kernels are templates over the view size and, for the actor
kernel, the hidden width.  The built-in libraries hold view 7 (and widths 64
and 256); any other ``Shape`` builds at its first launch, for the one family
that launches it (``Shape.ext_id``, a built-in ext's kernel id, or a user
ext's header) at its switches: ``-DMINIGRID_VIEW``, ``-DMINIGRID_HIDDEN``,
``-DMINIGRID_ONLY_EXT`` and the three switches' defines into
``ops/build/<name>-v<V>-h<H>-<hash>.so``
(``-v<V>-`` alone without a width), the hash covering the sources, the flags
and the shape.
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
from typing import NamedTuple

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

# name, or (name, header as given, struct, shape) -> its library, loaded
# once a process.
_LIBS: dict[object, ctypes.CDLL] = {}
# name (``name[struct]`` for a user ext, ``shape_key`` for a shape) ->
# (seconds the build took, nvcc's output including ptxas' register and
# spill report); absent when the library was already built.
BUILD_INFO: dict[str, tuple[float, str]] = {}


class Shape(NamedTuple):
    """A rollout kernel's instantiation outside the built-in libraries: the
    view size, the actor's hidden width (0 for the random-policy kernel),
    the kernel id of the one built-in ext it holds (None with a user ext's
    header, which holds that struct alone) and the family's switches
    NO_OBJECTS, STATIC_MISSION and SEE_THROUGH (0 or 1 each), which the
    library fixes (``csrc/fused_ext.cuh``'s ``LIBRARY_SWITCHES``).  One
    define a value: ``nvcc`` splits an option's value at commas."""

    view: int
    hidden: int
    ext_id: int | None
    switches: tuple[int, int, int]

    def flags(self) -> tuple[str, ...]:
        out = (f"-DMINIGRID_VIEW={self.view}",)
        if self.hidden:
            out += (f"-DMINIGRID_HIDDEN={self.hidden}",)
        if self.ext_id is not None:
            out += (f"-DMINIGRID_ONLY_EXT={self.ext_id}",)
        names = ("NO_OBJECTS", "STATIC_MISSION", "SEE_THROUGH")
        return out + tuple(f"-DMINIGRID_{n}={int(bool(x))}" for n, x in zip(names, self.switches))

    def tag(self) -> str:
        """``v<V>`` or ``v<V>-h<H>``: the library file's shape part."""
        return f"v{self.view}" + (f"-h{self.hidden}" if self.hidden else "")


def shape_key(name: str, shape: Shape, struct: str | None = None) -> str:
    """``BUILD_INFO``'s key of ``name``'s library at ``shape``:
    ``<name>-<tag>[ext <id>, switches <abc>]``, the user ext's struct in
    place of ``ext <id>``."""
    ext = struct if struct is not None else f"ext {shape.ext_id}"
    switches = "".join(str(int(bool(x))) for x in shape.switches)
    return f"{name}-{shape.tag()}[{ext}, switches {switches}]"


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


def library_path(name: str, header=None, struct: str | None = None, shape: Shape | None = None) -> Path:
    """Where ``load_library`` keeps ``csrc/<name>.cu``'s library: a hash of
    every file of ``csrc/`` and the flags, for a user ext (``header`` and
    ``struct``) of the header's path, the struct and every file in the
    header's directory, and for a ``shape`` of its defines, which also name
    the file.  Computing it needs no ``nvcc``."""
    digest = hashlib.sha256()
    for path in sorted(p for p in CSRC.rglob("*") if p.is_file()):
        digest.update(str(path.relative_to(CSRC)).encode() + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    stem = name
    if header is not None:
        path = _user_header(header, struct)
        digest.update(f"\0{path}\0{struct}\0".encode())
        for f in _header_files(path):
            digest.update(f.name.encode() + b"\0" + f.read_bytes())
        stem += "-user"
    if shape is not None:
        digest.update(("\0" + " ".join(shape.flags())).encode())
        stem += f"-{shape.tag()}"
    return BUILD_DIR / f"{stem}-{digest.hexdigest()[:16]}.so"


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


def library_key(name: str, header=None, struct: str | None = None, shape: Shape | None = None):
    """``_LIBS``' key of the library that ``load_library`` loads with these
    arguments."""
    return name if header is None and shape is None else (name, None if header is None else str(header), struct, shape)


def load_library(name: str, header=None, struct: str | None = None, shape: Shape | None = None) -> ctypes.CDLL:
    """The loaded ``csrc/<name>.cu`` library, built on first use; with
    ``header`` and ``struct``, the one built with that user ext as
    ``EXT_USER``; with a ``shape``, the one built for that view (and
    width) and ext alone.  A library is loaded once a process, as a Python
    module is imported once, so that a launch makes no file-system call;
    ``library_path`` keys the built files by content, so an edited header
    is rebuilt in the next process, never served from a stale build.  A
    failed build raises ``RuntimeError`` with ``nvcc``'s output."""
    key = library_key(name, header, struct, shape)
    if key not in _LIBS:
        src = CSRC / f"{name}.cu"
        path = None if header is None else _user_header(header, struct)
        out = library_path(name, path, struct, shape)
        if not out.exists():
            flags = NVCC_FLAGS + (() if shape is None else shape.flags())
            if shape is not None:
                info_key = shape_key(name, shape, struct)
            else:
                info_key = name if path is None else f"{name}[{struct}]"
            if path is None:
                _compile(src, out, flags, info_key)
            else:
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                with tempfile.TemporaryDirectory(dir=BUILD_DIR) as shim_dir:
                    Path(shim_dir, USER_SHIM).write_text(f'#include "{path}"\n')
                    flags += ("-I", shim_dir, "-I", str(CSRC), f"-DMINIGRID_USER_EXT={struct}")
                    _compile(src, out, flags, info_key)
        _LIBS[key] = ctypes.CDLL(str(out))
    return _LIBS[key]
