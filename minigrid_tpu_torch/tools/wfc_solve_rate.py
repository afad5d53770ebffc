"""The WFC solver's levels/s on the GPU, and its kernel against its plain version.

    python -m minigrid_tpu_torch.tools.wfc_solve_rate                    # MazeSimple 23x23
    python -m minigrid_tpu_torch.tools.wfc_solve_rate --waves 64 20480 --plain
    python -m minigrid_tpu_torch.tools.wfc_solve_rate --check

For each wave count, the solver kernel (``ops/wfc_solve.py``) on ``--preset``
at ``--size`` (the inner grid of a 25x25 level by default), twice; with
``--plain`` the plain version (``envs/wfc/solver.wfc_solve_reference``) once
beside it.  ``--check`` first holds the kernel against the plain version on
64 waves for every location and pattern heuristic, backtracking, and every
preset at 12x12: grids, outcomes and counters equal.  One JSON line a
measurement, the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from minigrid_tpu_torch.envs.wfc import solver
from minigrid_tpu_torch.envs.wfc.preprocess import WFC_PRESETS_ALL, build_tables

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


def _solve(preset: str, n: int, size: int, device, seed: int, plain: bool, **config):
    c = WFC_PRESETS_ALL[preset]
    t = build_tables(c)
    gen = torch.Generator(device=device).manual_seed(seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = solver.wfc_solve(
        gen, t["adj"], t["weights"], n, (size, size), c.output_periodic, with_stats=True, device=device,
        plain=plain, **config,
    )
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _same(a, b) -> bool:
    return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and all(torch.equal(a[2][k], b[2][k]) for k in a[2])


def check(device) -> None:
    """The kernel == the plain version on every heuristic and preset."""
    cases = [("MazeSimple", 23, dict(loc_heuristic=lo, choice_heuristic=ch, backtracking=bt)) for lo, ch, bt in HEURISTICS]
    cases += [(preset, 12, {}) for preset in WFC_PRESETS_ALL]
    for preset, size, config in cases:
        n = 8 if preset == "Maze" else 64
        (k, k_s), (p, p_s) = (_solve(preset, n, size, device, 7, plain, **config) for plain in (False, True))
        if not _same(k, p):
            raise AssertionError(f"wfc_solve kernel != plain version on {preset} {size}x{size} {config}")
        print(json.dumps({"check": preset, "size": size, **config, "waves": n, "same": True, "kernel_ms": k_s * 1e3,
                          "plain_ms": p_s * 1e3}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", default="MazeSimple")
    ap.add_argument("--size", type=int, default=23)
    ap.add_argument("--waves", type=int, nargs="+", default=[64, 20480, 81920])
    ap.add_argument("--plain", action="store_true", help="time the plain version beside the kernel")
    ap.add_argument("--check", action="store_true", help="hold the kernel against the plain version first")
    args = ap.parse_args()
    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(card, flush=True)
    if args.check:
        check(device)
    for n in args.waves:
        seconds = [_solve(args.preset, n, args.size, device, rep, False)[1] for rep in range(2)]
        row = {"preset": args.preset, "size": args.size, "waves": n, "kernel_ms": [s * 1e3 for s in seconds],
               "kernel_levels_per_s": [n / s for s in seconds]}
        if args.plain:
            (_, ok, stats), s = _solve(args.preset, n, args.size, device, 0, True)
            row.update(plain_ms=s * 1e3, plain_levels_per_s=n / s, ok=float(ok.float().mean()),
                       mean_collapses=float(stats["collapses"].float().mean()))
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
