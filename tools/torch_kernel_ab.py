"""Time the port's rollout kernels in two checkouts, in turns, on one card.

    python tools/torch_kernel_ab.py PARENT_TREE CHANGE_TREE

Each tree is a directory holding ``minigrid_tpu_torch/`` (for example a
``git archive`` of a commit).  The trees run in the order parent, change,
change, parent, each in its own process that imports the port from that
tree and builds its kernels there.  Every run prints one JSON line: the
card, the tree and the mean device time (CUDA events) of

- ``k1_dynobs_ms``: the random-policy rollout kernel on
  MiniGrid-Dynamic-Obstacles-8x8-v0, 65536 envs x 256 steps, observations
  off, with counter-reset seeds;
- ``k2_empty_ms``: the actor rollout kernel on MiniGrid-Empty-8x8-v0,
  8192 envs x 128 steps, hidden 256, with a two-slot reset cache.

Both calls exist in every tree since the counter reset came to the
random-policy kernel.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


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
    from minigrid_tpu_torch.ops import actor_rollout as ar
    from minigrid_tpu_torch.ops import fused_rollout as fr
    from minigrid_tpu_torch.ops.prng import draw_seeds
    from minigrid_tpu_torch.rl.model import ActorCritic

    if not mgt.__file__.startswith(tree):
        raise RuntimeError(f"imported the port from {mgt.__file__}, not from {tree}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    env = mgt.make("MiniGrid-Dynamic-Obstacles-8x8-v0")
    _, states = env.reset(65536, gen)
    actions = torch.randint(0, env.num_actions, (256, 65536), generator=gen, device=dev, dtype=torch.int32)
    seeds = draw_seeds(gen, 65536, dev)
    k1 = _time_ms(lambda: fr.fused_rollout_core(env, states, None, actions, False, seeds), 10)

    env = mgt.make("MiniGrid-Empty-8x8-v0")
    _, states = env.reset(8192, gen)
    weights = ar.repack_actor_params(ActorCritic(256, env.num_actions, generator=gen))
    cache = env.batch_reset_cache(8192, 2, gen)
    noise = ar.draw_bits(gen, (128, env.num_actions, 8192), dev)
    k2 = _time_ms(lambda: ar.fused_actor_rollout_core(env, weights, states, cache, noise), 5)
    return {"device": torch.cuda.get_device_name(0), "tree": tree, "k1_dynobs_ms": k1, "k2_empty_ms": k2}


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
