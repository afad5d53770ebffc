"""Where K1, the random-policy rollout kernel, spends its time on the card:
a phase split of every step and the wrapper's copies apart.

Run it on the GPU, from the repository's root:

    python -m minigrid_tpu_torch.tools.rollout_split
    python minigrid_tpu_torch/tools/rollout_split.py --tree DIR

``--tree`` splits the K1 of another checkout, a directory holding
``minigrid_tpu_torch/`` (for example a ``git archive`` of an older commit):
its package is imported and its ``ops/csrc`` built.  The tool builds an
instrumented copy of ``ops/csrc/fused_rollout.cu`` under
``ops/build/split/`` (nothing of the package's own build changes) with
per-lane ``clock64()`` sums of each step's phases: the pre-step hook (with
the action's load), the core step, the post-step hook, the reset (the cache
copy or the counter reset, with the owner's loads), the observation, and
the wait for the rest of the warp, read at a ``__syncwarp()`` after the
post-step hook and after the reset.  A source with the probe points
(``SPLIT_MARK``) gets them defined; one without them, the per-lane kernel
that copied a level one lane at a time, gets them inserted at its anchors
first.

Rows, at ``chip_smoke.py``'s shapes (65536 envs x 256 steps, BabyAI 16384;
the reset-cache families with episode ages spread over [0, max_steps) and R
from ``reset_budget.resets_for``): Empty-8x8 with observations off and on,
FourRooms, GoToObject-8x8-N2, Dynamic-Obstacles-8x8 (counter reset),
BabyAI-GoToLocal and BabyAI-GoTo, observations off but for the second.  For
each it prints one JSON line: the card, the row, the wrapper call's device
time and, apart, the kernel's and the device work before and after it (the
wrapper's copies; every call runs behind a spin kernel, so host time is not
in them), the instrumented kernel's time, and per phase the mean cycles a
lane spends in it per step and its share.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

SPIN_CYCLES = 100_000_000
PHASES = ("pre", "step", "post", "wait", "reset", "obs")
ROWS = (
    ("MiniGrid-Empty-8x8-v0", 65536, False, False),
    ("MiniGrid-Empty-8x8-v0", 65536, True, False),
    ("MiniGrid-FourRooms-v0", 65536, False, True),
    ("MiniGrid-GoToObject-8x8-N2-v0", 65536, False, True),
    ("MiniGrid-Dynamic-Obstacles-8x8-v0", 65536, False, False),
    ("BabyAI-GoToLocal-v0", 16384, False, True),
    ("BabyAI-GoTo-v0", 16384, False, True),
)
STEPS = 256

_HEADER = """__device__ unsigned long long g_split[8];
#define SPLIT_BEGIN() long long split_t = clock64(); unsigned long long split_acc[6] = {0, 0, 0, 0, 0, 0}
#define SPLIT_MARK(i) do { const long long split_now = clock64(); \\
    split_acc[i] += (unsigned long long)(split_now - split_t); split_t = split_now; } while (0)
#define SPLIT_SYNC(i) do { __syncwarp(); SPLIT_MARK(i); } while (0)
#define SPLIT_END(active) do { if (active) { for (int split_i = 0; split_i < 6; ++split_i) \\
    atomicAdd(&g_split[split_i], split_acc[split_i]); atomicAdd(&g_split[6], 1ull); } } while (0)
"""
_EXPORTS = """
extern "C" int split_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_split, sizeof(g_split));
}
extern "C" int split_reset() {
  unsigned long long z[8] = {0};
  return (int)cudaMemcpyToSymbol(g_split, z, sizeof(z));
}
"""
# The per-lane kernel's probe points: (anchor, text before it, text after
# it); the phases are numbered as in PHASES.
_ANCHORS = (
    ("  for (int t = 0; t < a.T; ++t) {\n", "  SPLIT_BEGIN();\n", ""),
    ("    if constexpr (Ext::PRE_STEP) Ext::pre_step(p, grid, planes, N, W, H, s, x);\n", "", "    SPLIT_MARK(0);\n"),
    (
        "    float reward = core_step<NO_OBJECTS>(grid, cont, N, W, H, s, Ext::map_action(action));\n",
        "",
        "    SPLIT_MARK(1);\n",
    ),
    ("    done_count += done;\n", "", "    SPLIT_MARK(2);\n    SPLIT_SYNC(3);\n"),
    ("      used += 1;\n    }\n", "", "    SPLIT_MARK(4);\n    SPLIT_SYNC(3);\n"),
    (
        "        for (int j = 0; j < V; ++j) obs_sum += (uint32_t)view[i][j];\n    }\n",
        "",
        "    SPLIT_MARK(5);\n",
    ),
    ("  store_scalars(sc, N, s);\n", "  SPLIT_END(true);\n", ""),
)


def instrumented_source(src: str) -> str:
    """``fused_rollout.cu`` with the phase sums defined (and, in a source
    without the probe points, inserted at the per-lane kernel's anchors)."""
    if "SPLIT_MARK" not in src:
        for anchor, before, after in _ANCHORS:
            if src.count(anchor) != 1:
                raise RuntimeError(f"fused_rollout.cu has no unique anchor {anchor!r}")
            src = src.replace(anchor, before + anchor + after)
    return _HEADER + src + _EXPORTS


def build_instrumented(csrc: Path, build_dir: Path, nvcc: str, flags) -> Path:
    """Builds the instrumented copy of ``csrc/fused_rollout.cu`` (with the
    other sources beside it) into ``build_dir/split/``; returns the
    library's path (reused when the sources are unchanged)."""
    text = instrumented_source((csrc / "fused_rollout.cu").read_text())
    digest = hashlib.sha256(text.encode() + " ".join(flags).encode())
    for path in sorted(p for p in csrc.rglob("*") if p.is_file()):
        digest.update(str(path.relative_to(csrc)).encode() + path.read_bytes())
    out_dir = build_dir / "split" / f"rollout-{digest.hexdigest()[:16]}"
    lib = out_dir / "librollout_split.so"
    if lib.exists():
        return lib
    if out_dir.exists():
        shutil.rmtree(out_dir)
    shutil.copytree(csrc, out_dir / "csrc")
    (out_dir / "csrc" / "fused_rollout.cu").write_text(text)
    proc = subprocess.run(
        [nvcc, *flags, "-o", str(lib), str(out_dir / "csrc" / "fused_rollout.cu")], capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the instrumented fused_rollout.cu:\n{proc.stdout}{proc.stderr}")
    return lib


class _TimedLaunch:
    """The library's launch function with CUDA events recorded around each
    call (its argtypes and restype set through)."""

    def __init__(self, fn):
        self.__dict__["fn"] = fn
        self.__dict__["marks"] = []

    def __setattr__(self, name, value):
        setattr(self.fn, name, value)

    def __call__(self, *args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        err = self.fn(*args)
        end.record()
        self.marks.append((start, end))
        return err


class _TimedLibrary:
    """A loaded rollout library whose ``fused_rollout_launch`` records CUDA
    events around each launch; every other symbol is the library's."""

    def __init__(self, lib):
        self.lib = lib
        self.fused_rollout_launch = _TimedLaunch(lib.fused_rollout_launch)

    def __getattr__(self, name):
        return getattr(self.lib, name)


def rows_inputs(mgt, device, rows=ROWS):
    """Per row: its label and the arguments of ``fused_rollout_core``, drawn
    from seed 0 as chip_smoke.py draws them."""
    from minigrid_tpu_torch.core.sampling import randint
    from minigrid_tpu_torch.ops.fused_rollout import counter_reset
    from minigrid_tpu_torch.ops.prng import draw_seeds
    from minigrid_tpu_torch.parallel.reset_budget import resets_for

    for env_id, n, obs, spread in rows:
        env = mgt.make(env_id)
        gen = torch.Generator(device=device).manual_seed(0)
        _, states = env.reset(n, gen, device)
        if spread:
            states = states.replace(step_count=randint(gen, n, 0, states.max_steps))
        actions = torch.randint(0, env.num_actions, (STEPS, n), generator=gen, device=device, dtype=torch.int32)
        if counter_reset(env):
            cache, seeds = None, draw_seeds(gen, n, device)
        else:
            cache, seeds = env.batch_reset_cache(n, resets_for(env, STEPS), gen, device), None
        yield f"{env_id} {n}x{STEPS} obs={'on' if obs else 'off'}", env, (states, cache, actions, obs, seeds)


def split_row(fr, build, split_lib, env, args) -> dict:
    """One row: the wrapper call behind a spin, twice, the kernel's events
    inside it; then the instrumented kernel's phase sums."""
    lib = _TimedLibrary(build.load_library("fused_rollout"))
    states = args[0]
    n = states.step_count.shape[0]
    saved = build._LIBS["fused_rollout"]
    best = None
    try:
        for _ in range(2):
            build._LIBS["fused_rollout"] = lib
            torch.cuda.synchronize()
            torch.cuda._sleep(SPIN_CYCLES)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fr.fused_rollout_core(env, *args)
            end.record()
            torch.cuda.synchronize()
            k0, k1 = lib.fused_rollout_launch.marks[-1]
            times = (start.elapsed_time(end), k0.elapsed_time(k1), start.elapsed_time(k0), k1.elapsed_time(end))
            best = times if best is None or times[0] < best[0] else best
        build._LIBS["fused_rollout"] = _TimedLibrary(split_lib)
        check = getattr(split_lib, "split_reset")()
        fr.fused_rollout_core(env, *args)
        torch.cuda.synchronize()
        marks = build._LIBS["fused_rollout"].fused_rollout_launch.marks
        instrumented_ms = marks[-1][0].elapsed_time(marks[-1][1])
        sums = (ctypes.c_ulonglong * 8)()
        check |= split_lib.split_read(sums)
    finally:
        build._LIBS["fused_rollout"] = saved
    if check != 0 or sums[6] != n:
        raise RuntimeError(f"the instrumented kernel's sums were not read (error {check}, {sums[6]} lanes of {n})")
    lane_steps = n * STEPS
    total = sum(sums[:6])
    return {
        "wrapper_ms": best[0],
        "kernel_ms": best[1],
        "copies_before_ms": best[2],
        "copies_after_ms": best[3],
        "instrumented_ms": instrumented_ms,
        "cycles_per_lane_step": {p: sums[i] / lane_steps for i, p in enumerate(PHASES)},
        "share": {p: sums[i] / total for i, p in enumerate(PHASES)},
    }


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def run(tree: Path | None = None, rows=ROWS, split_path: Path | None = None) -> list[dict]:
    """The split of every row of ``rows`` for the package of ``tree`` (the
    one imported, where None); ``split_path``: an instrumented library built
    already.  Prints and returns one record per row."""
    if tree is not None:
        sys.path.insert(0, str(tree.resolve()))
    import minigrid_tpu_torch as mgt
    from minigrid_tpu_torch.ops import _build as build
    from minigrid_tpu_torch.ops import fused_rollout as fr

    if tree is not None and not mgt.__file__.startswith(str(tree.resolve())):
        raise RuntimeError(f"imported the port from {mgt.__file__}, not from {tree}")
    if not torch.cuda.is_available():
        raise RuntimeError("rollout_split needs a CUDA card")
    device = torch.device("cuda", 0)
    if split_path is None:
        split_path = build_instrumented(build.CSRC, build.BUILD_DIR, build._nvcc(), build.NVCC_FLAGS)
    split_lib = ctypes.CDLL(str(split_path))
    split_lib.split_read.argtypes = [ctypes.c_void_p]
    build.load_library("fused_rollout")
    who = card()
    records = []
    for label, env, args in rows_inputs(mgt, device, rows):
        record = {"card": who, "tree": str(Path(mgt.__file__).resolve().parents[1]), "row": label}
        record.update(split_row(fr, build, split_lib, env, args))
        print(json.dumps(record), flush=True)
        records.append(record)
    return records


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", type=Path, default=None, help="a checkout whose K1 to split")
    args = parser.parse_args(argv)
    tree = args.tree
    if tree is None and __package__ in (None, ""):
        tree = Path(__file__).resolve().parents[2]
    run(tree)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
