"""Time the port's rollout kernels and WFC solver in two checkouts, in turns,
on one card.

    python tools/torch_kernel_ab.py PARENT_TREE CHANGE_TREE

Each tree is a directory holding ``minigrid_tpu_torch/`` (for example a
``git archive`` of a commit).  The trees run in the order parent, change,
change, parent, each in its own process that imports the port from that
tree and builds its kernels there.  Every run prints one JSON line: the
card, the tree and, per row, the time of one whole wrapper call in ms
(CUDA events around 5 calls after a warm-up, as ``chip_smoke.py`` times
them; the solver rows around 3, 10 and 20), on the same inputs in both
trees (drawn from seed 0):

- ``k1[<id> obs=off|on]``: the random-policy rollout kernel (K1) on every
  family of ``chip_smoke.py``'s slices at their sizes: 65536 envs x 256
  steps (BabyAI 16384), Empty-8x8 through an R-slot cache, the
  counter-reset families with seeds, the reset-cache families (DoorKey,
  FourRooms, GoToObject, GoToDoor, Fetch, BabyAI) with episode ages spread
  over [0, max_steps) and R from ``reset_budget.resets_for``;
- ``k2[<id>]``: the actor rollout kernel (K2), 8192 envs x 128 steps,
  hidden 256, on MiniGrid-Empty-8x8-v0 with a two-slot reset cache and on
  MiniGrid-Dynamic-Obstacles-8x8-v0 with reset seeds;
- ``wfc[MazeSimple n=<N>]``: the WFC solver kernel through
  ``envs/wfc/solver.wfc_solve`` on N = 20480 (a reset cache's chunk), 64
  (bench.py's batch) and 1 (a gym shim reset) MazeSimple waves of 23x23,
  the seeds drawn from seed 0.

Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

K1_ROWS = (
    ("MiniGrid-Empty-8x8-v0", 65536, False),
    ("MiniGrid-Empty-Random-5x5-v0", 65536, False),
    ("MiniGrid-LavaCrossingS9N2-v0", 65536, False),
    ("MiniGrid-Dynamic-Obstacles-8x8-v0", 65536, False),
    ("MiniGrid-DoorKey-8x8-v0", 65536, True),
    ("MiniGrid-FourRooms-v0", 65536, True),
    ("MiniGrid-GoToObject-8x8-N2-v0", 65536, True),
    ("MiniGrid-GoToDoor-8x8-v0", 65536, True),
    ("MiniGrid-Fetch-8x8-N3-v0", 65536, True),
    ("BabyAI-GoToLocal-v0", 16384, True),
    ("BabyAI-GoTo-v0", 16384, True),
)
K2_IDS = ("MiniGrid-Empty-8x8-v0", "MiniGrid-Dynamic-Obstacles-8x8-v0")
# WFC solver rows: waves, and calls a timing.
WFC_ROWS = ((20480, 3), (64, 10), (1, 20))
STEPS = 256


def _time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_tree(tree: str) -> dict:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    import minigrid_tpu_torch as mgt
    from minigrid_tpu_torch.core.sampling import randint
    from minigrid_tpu_torch.envs.wfc import solver as wfc_solver
    from minigrid_tpu_torch.envs.wfc.preprocess import WFC_PRESETS, preset_tables
    from minigrid_tpu_torch.ops import actor_rollout as ar
    from minigrid_tpu_torch.ops import fused_rollout as fr
    from minigrid_tpu_torch.ops.prng import draw_seeds
    from minigrid_tpu_torch.parallel.reset_budget import resets_for
    from minigrid_tpu_torch.rl.model import ActorCritic

    if not mgt.__file__.startswith(tree):
        raise RuntimeError(f"imported the port from {mgt.__file__}, not from {tree}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card")
    dev = torch.device("cuda", 0)
    times = {}
    for env_id, n, spread in K1_ROWS:
        env = mgt.make(env_id)
        gen = torch.Generator(device=dev).manual_seed(0)
        _, states = env.reset(n, gen)
        if spread:
            states = states.replace(step_count=randint(gen, n, 0, states.max_steps))
        actions = torch.randint(0, env.num_actions, (STEPS, n), generator=gen, device=dev, dtype=torch.int32)
        if fr.counter_reset(env):
            cache, seeds = None, draw_seeds(gen, n, dev)
        else:
            cache, seeds = env.batch_reset_cache(n, resets_for(env, STEPS), gen, dev), None
        for obs in (False, True):
            call = lambda: fr.fused_rollout_core(env, states, cache, actions, obs, seeds)  # noqa: E731
            times[f"k1[{env_id} obs={'on' if obs else 'off'}]"] = _time_ms(call, 5)
        del states, cache, actions, seeds

    for env_id in K2_IDS:
        env = mgt.make(env_id)
        gen = torch.Generator(device=dev).manual_seed(0)
        _, states = env.reset(8192, gen)
        weights = ar.repack_actor_params(ActorCritic(256, env.num_actions, generator=gen))
        noise = ar.draw_bits(gen, (128, env.num_actions, 8192), dev)
        if fr.counter_reset(env):
            cache, seeds = None, draw_seeds(gen, 8192, dev)
        else:
            cache, seeds = env.batch_reset_cache(8192, 2, gen), None
        call = lambda: ar.fused_actor_rollout_core(env, weights, states, cache, noise, seeds)  # noqa: E731
        times[f"k2[{env_id}]"] = _time_ms(call, 5)

    t, config = preset_tables("MazeSimple"), WFC_PRESETS["MazeSimple"]
    for n, reps in WFC_ROWS:
        gen = torch.Generator(device=dev)

        def call():
            gen.manual_seed(0)
            wfc_solver.wfc_solve(gen, t["adj"], t["weights"], n, (23, 23), config.output_periodic, device=dev)

        times[f"wfc[MazeSimple n={n}]"] = _time_ms(call, reps)
    return {"device": torch.cuda.get_device_name(0), "tree": tree, "ms": times}


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(time_tree(argv[1])), flush=True)
        return 0
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    parent, change = argv
    for tree in (parent, change, change, parent):
        subprocess.run([sys.executable, __file__, "--one", tree], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
