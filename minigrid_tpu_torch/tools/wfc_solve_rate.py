"""The WFC solver's levels/s on the GPU, its kernel against its plain version,
and the kernel's phase split.

    python -m minigrid_tpu_torch.tools.wfc_solve_rate                    # MazeSimple 23x23
    python -m minigrid_tpu_torch.tools.wfc_solve_rate --waves 64 20480 --plain
    python -m minigrid_tpu_torch.tools.wfc_solve_rate --check
    python -m minigrid_tpu_torch.tools.wfc_solve_rate --split [--waves 20480]
    python minigrid_tpu_torch/tools/wfc_solve_rate.py --split --tree DIR

For each wave count, the solver kernel (``ops/wfc_solve.py``) on ``--preset``
at ``--size`` (the inner grid of a 25x25 level by default), twice; with
``--plain`` the plain version (``envs/wfc/solver.wfc_solve_reference``) once
beside it.  ``--check`` first holds the kernel against the plain version on
64 waves for every location and pattern heuristic, backtracking, and every
preset at 12x12: grids, outcomes and counters equal.  One JSON line a
measurement, the card's name and power limit first.

``--split`` builds an instrumented copy of ``ops/csrc/wfc_solve.cu`` under
``ops/build/split/`` (the package's own build is untouched) and reports,
per wave count, where the kernel's time goes: the cycles of each phase of
the collapse loop per collapse, read on the clock of the thread that runs
the wave's decisions (thread 0 of the block-per-wave design, lane 0 of the
warp-per-wave one), summed over the waves: ``init`` (an attempt's fresh
wave and preferences), ``location``, ``draw`` (the pattern, with the
global counts of rarest and most-common), ``snapshot`` (backtracking's copy),
``propagation`` (with the backtrack's restore and ban) and ``other`` (the
collapse's write, the grid written out); the propagation's rounds (sweeps or
work-list batches) and cells checked per collapse; and the waits: in the
block-per-wave design the thread-cycles spent at block barriers over all
thread-cycles, in the warp-per-wave one the warp-cycles a finished warp
holds its block's shared memory while the block's other waves still run,
over all warp-cycles.  A source with the probes (``WFC_SPLIT``) gets them
compiled in; the block-per-wave source, which has none, gets them inserted
at its anchors.  ``--tree DIR`` splits the kernel of another checkout, a
directory holding ``minigrid_tpu_torch/`` (for example a ``git archive`` of
an older commit).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

HEURISTICS = (
    ("entropy", "weighted", False),
    ("anti-entropy", "random", False),
    ("random", "rarest", False),
    ("simple", "most-common", False),
    ("lexical", "lexical", False),
    ("spiral", "weighted", False),
    ("hilbert", "weighted", False),
    ("entropy", "weighted", True),
)
PHASES = ("init", "location", "draw", "snapshot", "propagation", "other")
# g_split slots of the instrumented copy: the phases' cycles (0-5), the
# waves that reported (7), the waits and the cycles they are a share of (8,
# 9), the propagation's rounds and cells checked (10, 11).
SLOTS = 16

_HEADER = """#define WFC_SPLIT 1
__device__ unsigned long long g_split[16];
"""
_EXPORTS = """
extern "C" int split_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_split, sizeof(g_split));
}
extern "C" int split_reset() {
  unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(g_split, z, sizeof(z));
}
"""
# The block-per-wave source (128 threads a block): thread 0's clock splits
# the phases, every thread times its own block barriers.
_BLOCK_PROBES = """__shared__ unsigned long long split_wait[128];
__shared__ unsigned long long split_cells[128];
__shared__ unsigned long long split_rounds;
__device__ __forceinline__ void split_sync() {
  const long long t = clock64();
  __syncthreads();
  split_wait[threadIdx.x] += (unsigned long long)(clock64() - t);
}
__device__ __forceinline__ int split_sync_or(int p) {
  const long long t = clock64();
  const int r = __syncthreads_or(p);
  split_wait[threadIdx.x] += (unsigned long long)(clock64() - t);
  return r;
}
__device__ __forceinline__ int split_sync_and(int p) {
  const long long t = clock64();
  const int r = __syncthreads_and(p);
  split_wait[threadIdx.x] += (unsigned long long)(clock64() - t);
  return r;
}
#define SPLIT_BEGIN() long long split_t = clock64(); const long long split_t0 = split_t; \\
    unsigned long long split_acc[6] = {0, 0, 0, 0, 0, 0}; split_wait[threadIdx.x] = 0; \\
    split_cells[threadIdx.x] = 0; if (threadIdx.x == 0) split_rounds = 0
#define SPLIT_MARK(i) do { const long long split_now = clock64(); \\
    split_acc[i] += (unsigned long long)(split_now - split_t); split_t = split_now; } while (0)
#define SPLIT_ROUND() do { if (threadIdx.x == 0) ++split_rounds; } while (0)
#define SPLIT_CELL() ++split_cells[threadIdx.x]
#define SPLIT_END() do { atomicAdd(&g_split[8], split_wait[threadIdx.x]); \\
    atomicAdd(&g_split[9], (unsigned long long)(clock64() - split_t0)); \\
    atomicAdd(&g_split[11], split_cells[threadIdx.x]); if (threadIdx.x == 0) { \\
    for (int split_i = 0; split_i < 6; ++split_i) atomicAdd(&g_split[split_i], split_acc[split_i]); \\
    atomicAdd(&g_split[10], split_rounds); atomicAdd(&g_split[7], 1ull); } } while (0)
"""
# (anchor, text before it, text after it), phases numbered as in PHASES.
_BLOCK_ANCHORS = (
    ("  const int max_steps = 4 * cells;\n", "", "  SPLIT_BEGIN();\n"),
    (
        "    bool failed = propagate<NW>(wave, compat, dirty, P, W, H, periodic);\n",
        "    SPLIT_MARK(0);\n",
        "    SPLIT_MARK(4);\n",
    ),
    ("      const int cell = choose_location<NW>(wave, prefs, cells, prm.loc, red, &solved);\n", "", "      SPLIT_MARK(1);\n"),
    (
        "      if (backtracking) {\n        for (int i = threadIdx.x; i < cells * NW; i += THREADS) snap[i] = wave[i];\n      }\n",
        "      SPLIT_MARK(2);\n",
        "      SPLIT_MARK(3);\n",
    ),
    ("      bool contradiction = propagate<NW>(wave, compat, dirty, P, W, H, periodic);\n", "      SPLIT_MARK(5);\n", ""),
    ("      failed = contradiction;\n", "      SPLIT_MARK(4);\n", ""),
    ("    ok = solved && !failed;\n", "    SPLIT_MARK(5);\n", ""),
    ("  if (threadIdx.x == 0) {\n    prm.ok[lane] = ok;\n", "  SPLIT_MARK(5);\n  SPLIT_END();\n", ""),
    ("    int changed = 0;\n", "", "    SPLIT_ROUND();\n"),
    ("      cur[c] = 0;\n", "", "      SPLIT_CELL();\n"),
)
_BLOCK_BARRIERS = (("__syncthreads_or(", "split_sync_or("), ("__syncthreads_and(", "split_sync_and("), ("__syncthreads();", "split_sync();"))


def instrumented_source(src: str) -> str:
    """``wfc_solve.cu`` with the probes on: compiled in where the source has
    them, inserted at the block-per-wave kernel's anchors where it has not."""
    if "WFC_SPLIT" not in src:
        for anchor, before, after in _BLOCK_ANCHORS:
            if src.count(anchor) != 1:
                raise RuntimeError(f"wfc_solve.cu has no unique anchor {anchor!r}")
            src = src.replace(anchor, before + anchor + after)
        for old, new in _BLOCK_BARRIERS:
            src = src.replace(old, new)
        src = _BLOCK_PROBES + src
    return _HEADER + src + _EXPORTS


def build_instrumented(csrc: Path, build_dir: Path, nvcc: str, flags) -> Path:
    """Builds the instrumented copy of ``csrc/wfc_solve.cu`` (the headers
    beside it) into ``build_dir/split/``; returns the library's path,
    reused while the sources are unchanged."""
    text = instrumented_source((csrc / "wfc_solve.cu").read_text())
    digest = hashlib.sha256(text.encode() + " ".join(flags).encode())
    for path in sorted(p for p in csrc.rglob("*") if p.is_file()):
        digest.update(str(path.relative_to(csrc)).encode() + path.read_bytes())
    out_dir = build_dir / "split" / f"wfc-{digest.hexdigest()[:16]}"
    lib = out_dir / "libwfc_split.so"
    if lib.exists():
        return lib
    if out_dir.exists():
        shutil.rmtree(out_dir)
    shutil.copytree(csrc, out_dir / "csrc")
    (out_dir / "csrc" / "wfc_solve.cu").write_text(text)
    proc = subprocess.run(
        [nvcc, *flags, "-o", str(lib), str(out_dir / "csrc" / "wfc_solve.cu")], capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the instrumented wfc_solve.cu:\n{proc.stdout}{proc.stderr}")
    return lib


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _import(tree: Path | None):
    """The port's package, from ``tree`` where given."""
    if tree is not None:
        sys.path.insert(0, str(tree.resolve()))
    import minigrid_tpu_torch as mgt

    if tree is not None and not mgt.__file__.startswith(str(tree.resolve())):
        raise RuntimeError(f"imported the port from {mgt.__file__}, not from {tree}")
    return mgt


def problem(preset: str, size: int) -> tuple:
    """``envs/wfc/solver.wfc_solve``'s arguments after the waves' count for
    ``preset`` at ``size`` x ``size``: the adjacency and weights of its
    patterns, the shape and its periodicity."""
    from minigrid_tpu_torch.envs.wfc.preprocess import WFC_PRESETS_ALL, build_tables

    c = WFC_PRESETS_ALL[preset]
    t = build_tables(c)
    return t["adj"], t["weights"], (size, size), c.output_periodic


def _solve(preset: str, n: int, size: int, device, seed: int, plain: bool, **config):
    import torch

    from minigrid_tpu_torch.envs.wfc import solver

    adj, weights, shape, periodic = problem(preset, size)
    gen = torch.Generator(device=device).manual_seed(seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = solver.wfc_solve(
        gen, adj, weights, n, shape, periodic, with_stats=True, device=device, plain=plain, **config,
    )
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _same(a, b) -> bool:
    import torch

    return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and all(torch.equal(a[2][k], b[2][k]) for k in a[2])


def check(device) -> None:
    """The kernel == the plain version on every heuristic and preset."""
    from minigrid_tpu_torch.envs.wfc.preprocess import WFC_PRESETS_ALL

    cases = [("MazeSimple", 23, dict(loc_heuristic=lo, choice_heuristic=ch, backtracking=bt)) for lo, ch, bt in HEURISTICS]
    cases += [(preset, 12, {}) for preset in WFC_PRESETS_ALL]
    for preset, size, config in cases:
        n = 8 if preset == "Maze" else 64
        (k, k_s), (p, p_s) = (_solve(preset, n, size, device, 7, plain, **config) for plain in (False, True))
        if not _same(k, p):
            raise AssertionError(f"wfc_solve kernel != plain version on {preset} {size}x{size} {config}")
        print(json.dumps({"check": preset, "size": size, **config, "waves": n, "same": True, "kernel_ms": k_s * 1e3,
                          "plain_ms": p_s * 1e3}), flush=True)


def split(tree: Path | None, preset: str, size: int, waves) -> list[dict]:
    """The phase split of the kernel of ``tree`` (the package imported, where
    None) at each wave count: one record each, printed and returned."""
    import torch

    mgt = _import(tree)
    from minigrid_tpu_torch.ops import _build as build

    device = torch.device("cuda", 0)
    split_lib = ctypes.CDLL(str(build_instrumented(build.CSRC, build.BUILD_DIR, build._nvcc(), build.NVCC_FLAGS)))
    split_lib.split_read.argtypes = [ctypes.c_void_p]
    own = build.load_library("wfc_solve")
    who = card()
    records = []
    for n in waves:
        try:
            times = []
            for _ in range(2):
                (_, _, stats), seconds = _solve(preset, n, size, device, 0, False)
                times.append(seconds * 1e3)
            build._LIBS["wfc_solve"] = split_lib
            err = split_lib.split_reset()
            _, seconds = _solve(preset, n, size, device, 0, False)
            sums = (ctypes.c_ulonglong * SLOTS)()
            err |= split_lib.split_read(sums)
        finally:
            build._LIBS["wfc_solve"] = own
        if err != 0 or sums[7] != n:
            raise RuntimeError(f"the instrumented kernel's sums were not read (error {err}, {sums[7]} waves of {n})")
        collapses = int(stats["collapses"].sum(dtype=torch.int64))
        total = sum(sums[:6])
        record = {
            "card": who, "tree": str(Path(mgt.__file__).resolve().parents[1]), "preset": preset, "size": size,
            "waves": n, "kernel_ms": times, "instrumented_ms": seconds * 1e3, "collapses": collapses,
            "cycles_per_collapse": {p: sums[i] / collapses for i, p in enumerate(PHASES)},
            "share": {p: sums[i] / total for i, p in enumerate(PHASES)},
            "rounds_per_collapse": sums[10] / collapses, "cells_checked_per_collapse": sums[11] / collapses,
            "wait_share": sums[8] / sums[9],
        }
        print(json.dumps(record), flush=True)
        records.append(record)
    return records


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", default="MazeSimple")
    ap.add_argument("--size", type=int, default=23)
    ap.add_argument("--waves", type=int, nargs="+", default=None, help="default 64 20480 81920 (--split: 20480)")
    ap.add_argument("--plain", action="store_true", help="time the plain version beside the kernel")
    ap.add_argument("--check", action="store_true", help="hold the kernel against the plain version first")
    ap.add_argument("--split", action="store_true", help="the instrumented kernel's phase split")
    ap.add_argument("--tree", type=Path, default=None, help="with --split: a checkout whose kernel to split")
    args = ap.parse_args(argv)
    tree = args.tree
    if tree is None and __package__ in (None, ""):
        tree = Path(__file__).resolve().parents[2]
    if args.split:
        split(tree, args.preset, args.size, args.waves or [20480])
        return 0
    _import(tree)
    import torch

    device = torch.device("cuda")
    print(card(), flush=True)
    if args.check:
        check(device)
    for n in args.waves or [64, 20480, 81920]:
        seconds = [_solve(args.preset, n, args.size, device, rep, False)[1] for rep in range(2)]
        row = {"preset": args.preset, "size": args.size, "waves": n, "kernel_ms": [s * 1e3 for s in seconds],
               "kernel_levels_per_s": [n / s for s in seconds]}
        if args.plain:
            (_, ok, stats), s = _solve(args.preset, n, args.size, device, 0, True)
            row.update(plain_ms=s * 1e3, plain_levels_per_s=n / s, ok=float(ok.float().mean()),
                       mean_collapses=float(stats["collapses"].float().mean()))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
