"""Measure the episodes per env per 256-step chunk that size the reset cache.

The port's counterpart of the JAX package's ``tools/measure_reset_budget.py``.
For each configuration it chains random-policy chunks under the reference's
contract, a fresh level at every episode end, and reports the per-env
episode count per chunk: its maximum (``reset_budget.
MEASURED_MAX_EPISODES_256``) and its mean (``MEASURED_MEAN_EPISODES_256``).
By default the chain starts in the steady state, not at a reset: every
env's episode age is drawn uniformly from [0, its max_steps), so that
truncations fall in every chunk and not in waves (Fetch-8x8-N3's 320-step
limit, GoTo's 576, would otherwise put them in one chunk of four);
``--from-reset`` starts it at a reset, as the JAX package's tool does.
Two measurements keep that contract:

* ``plain``: the batched step with per-step regeneration of every ended
  episode, counting ends per env (no cache, so nothing replays);
* ``kernel``: the whole-rollout kernel with a generous reset cache of R
  fresh levels per env, certified chunk by chunk by ``max_used < R``: no env
  reached the last slot, so every reset drew a level of its own.  A chunk
  whose ``max_used`` reaches R is run again, from the same states, at a
  larger R.  The kernel reports the maximum and the episode total, so the
  mean is total / N.  This is far faster where a level costs much to
  generate (GoTo's 22x22 mazes).

Run it on the GPU, from the repository's root:

    python -m minigrid_tpu_torch.tools.measure_reset_budget              # every config
    python -m minigrid_tpu_torch.tools.measure_reset_budget --env BabyAI-GoToLocal-v0 --num-envs 16384

One JSON line per configuration.  Counter-reset families (no cache) take
the plain measurement; the rest the kernel's unless ``--plain``.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

import minigrid_tpu_torch as mgt
from minigrid_tpu_torch.core.sampling import randint
from minigrid_tpu_torch.ops.fused_rollout import counter_reset, fused_rollout
from minigrid_tpu_torch.parallel.reset_budget import resets_for

# (env id, num_envs): the cached ids the port's kernels run, at the size
# the JAX package's bench and measurements used (bench.py:58-62).
CONFIGS = (
    ("MiniGrid-GoToObject-6x6-N2-v0", 65536),
    ("MiniGrid-GoToObject-8x8-N2-v0", 65536),
    ("MiniGrid-GoToDoor-5x5-v0", 65536),
    ("MiniGrid-GoToDoor-6x6-v0", 65536),
    ("MiniGrid-GoToDoor-8x8-v0", 65536),
    ("MiniGrid-Fetch-5x5-N2-v0", 65536),
    ("MiniGrid-Fetch-6x6-N2-v0", 65536),
    ("MiniGrid-Fetch-8x8-N3-v0", 65536),
    ("BabyAI-GoToLocal-v0", 16384),
    ("BabyAI-GoTo-v0", 16384),
    # The classic zoo's last slice, at chip_smoke.py's sizes: bench.py's
    # 8192 for ObstructedMaze, 16384 for the 19x19 and 25x25 grids.
    ("MiniGrid-ObstructedMaze-2Dlh-v0", 8192),
    ("MiniGrid-ObstructedMaze-Full-v1", 8192),
    ("MiniGrid-Unlock-v0", 65536),
    ("MiniGrid-BlockedUnlockPickup-v0", 65536),
    ("MiniGrid-KeyCorridorS3R3-v0", 65536),
    ("MiniGrid-KeyCorridorS6R3-v0", 65536),
    ("MiniGrid-DistShift1-v0", 65536),
    ("MiniGrid-LavaGapS7-v0", 65536),
    ("MiniGrid-MemoryS17Random-v0", 65536),
    ("MiniGrid-PutNear-8x8-N3-v0", 65536),
    ("MiniGrid-RedBlueDoors-8x8-v0", 65536),
    ("MiniGrid-LockedRoom-v0", 16384),
    ("MiniGrid-Playground-v0", 16384),
    ("MiniGrid-MultiRoom-N6-v0", 16384),
    # The rest of BabyAI, at bench.py's BabyAI size.
    *((env_id, 16384) for env_id in (
        "BabyAI-Open-v0", "BabyAI-OpenRedDoor-v0", "BabyAI-OpenDoor-v0", "BabyAI-OpenDoorDebug-v0",
        "BabyAI-OpenDoorColor-v0", "BabyAI-OpenDoorLoc-v0", "BabyAI-OpenTwoDoors-v0", "BabyAI-OpenRedBlueDoors-v0",
        "BabyAI-OpenRedBlueDoorsDebug-v0", "BabyAI-OpenDoorsOrderN2-v0", "BabyAI-OpenDoorsOrderN4-v0",
        "BabyAI-OpenDoorsOrderN2Debug-v0", "BabyAI-OpenDoorsOrderN4Debug-v0",
        "BabyAI-Pickup-v0", "BabyAI-UnblockPickup-v0", "BabyAI-PickupLoc-v0", "BabyAI-PickupDist-v0",
        "BabyAI-PickupDistDebug-v0", "BabyAI-PickupAbove-v0",
        "BabyAI-PutNextLocal-v0", "BabyAI-PutNextLocalS5N3-v0", "BabyAI-PutNextLocalS6N4-v0", "BabyAI-PutNextS4N1-v0",
        "BabyAI-PutNextS5N2-v0", "BabyAI-PutNextS5N1-v0", "BabyAI-PutNextS6N3-v0", "BabyAI-PutNextS7N4-v0",
        "BabyAI-PutNextS5N2Carrying-v0", "BabyAI-PutNextS6N3Carrying-v0", "BabyAI-PutNextS7N4Carrying-v0",
        "BabyAI-Unlock-v0", "BabyAI-UnlockLocal-v0", "BabyAI-UnlockLocalDist-v0", "BabyAI-KeyInBox-v0",
        "BabyAI-UnlockPickup-v0", "BabyAI-UnlockPickupDist-v0", "BabyAI-BlockedUnlockPickup-v0",
        "BabyAI-UnlockToUnlock-v0",
        "BabyAI-ActionObjDoor-v0", "BabyAI-FindObjS5-v0", "BabyAI-FindObjS6-v0", "BabyAI-FindObjS7-v0",
        "BabyAI-KeyCorridor-v0", "BabyAI-KeyCorridorS3R1-v0", "BabyAI-KeyCorridorS3R2-v0",
        "BabyAI-KeyCorridorS3R3-v0", "BabyAI-KeyCorridorS4R3-v0", "BabyAI-KeyCorridorS5R3-v0",
        "BabyAI-KeyCorridorS6R3-v0", "BabyAI-OneRoomS8-v0", "BabyAI-OneRoomS12-v0", "BabyAI-OneRoomS16-v0",
        "BabyAI-OneRoomS20-v0", "BabyAI-MoveTwoAcrossS5N2-v0", "BabyAI-MoveTwoAcrossS8N9-v0",
        "BabyAI-GoToSeq-v0", "BabyAI-GoToSeqS5R2-v0", "BabyAI-Synth-v0", "BabyAI-SynthS5R2-v0",
        "BabyAI-SynthLoc-v0", "BabyAI-SynthSeq-v0", "BabyAI-MiniBossLevel-v0", "BabyAI-BossLevel-v0",
        "BabyAI-BossLevelNoUnlock-v0",
    )),
    # WFC's six presets (25x25), at chip_smoke.py's size.
    *((f"MiniGrid-WFC-{preset}-v0", 16384) for preset in (
        "MazeSimple", "DungeonMazeScaled", "RoomsFabric", "ObstaclesBlackdots", "ObstaclesAngular", "ObstaclesHogs3",
    )),
)


def measure_plain(env, states, generator, num_steps: int, chunks: int):
    """Per-chunk (max, mean) episodes per env on the per-step regeneration
    path."""
    n, device = states.step_count.shape[0], states.device
    rows = []
    for _ in range(chunks):
        count = torch.zeros(n, dtype=torch.int32, device=device)
        for _ in range(num_steps):
            actions = torch.randint(0, env.num_actions, (n,), generator=generator, device=device, dtype=torch.int32)
            stepped, _ = env.step_env(states, actions)
            count += (stepped.terminated | stepped.truncated).int()
            states = env.autoreset(stepped, generator)
        rows.append((int(count.max()), float(count.float().mean()), None))
    return rows


def measure_kernel(env, states, generator, num_steps: int, chunks: int, resets: int):
    """Per-chunk (max, mean, certifying R) episodes per env through the
    kernel, each chunk certified by ``max_used < R``."""
    n = states.step_count.shape[0]
    rows = []
    for _ in range(chunks):
        snapshot = generator.get_state()
        while True:
            final, _, done, _, max_used = fused_rollout(env, states, generator, num_steps, resets, compute_obs=False)
            if int(max_used) < resets:
                break
            # Some env replayed a level: grow R past what it used, and run
            # the chunk again on the same draws up to the cache's.
            resets = int(max_used) + int(max_used) // 2 + 2
            generator.set_state(snapshot)
        rows.append((int(max_used), int(done) / n, resets))
        states = final
    return rows


def measure(
    env_id: str,
    num_envs: int,
    num_steps: int,
    chunks: int,
    plain: bool,
    device,
    seed: int = 7,
    resets: int | None = None,
    from_reset: bool = False,
) -> dict:
    """One configuration's measurement (``resets``: the kernel's first R,
    by default twice ``resets_for``'s)."""
    env = mgt.make(env_id)
    generator = torch.Generator(device=device).manual_seed(seed)
    _, states = env.reset(num_envs, generator, device)
    if not from_reset:
        states = states.replace(step_count=randint(generator, num_envs, 0, states.max_steps))
    start = time.perf_counter()
    if plain or counter_reset(env):
        how, rows = "plain", measure_plain(env, states, generator, num_steps, chunks)
    else:
        resets = resets or 2 * resets_for(env, num_steps)
        how, rows = "kernel", measure_kernel(env, states, generator, num_steps, chunks, resets)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {
        "env_id": env_id,
        "num_envs": num_envs,
        "num_steps": num_steps,
        "how": how,
        "start": "reset" if from_reset else "spread episode ages",
        "per_chunk_max": [r[0] for r in rows],
        "per_chunk_mean": [r[1] for r in rows],
        "certified_at_R": [r[2] for r in rows],
        "max": max(r[0] for r in rows),
        "mean_episodes_per_chunk": sum(r[1] for r in rows) / len(rows),
        "seconds": time.perf_counter() - start,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--env", default=None)
    ap.add_argument("--num-envs", type=int, default=65536)
    ap.add_argument("--num-steps", type=int, default=256)
    ap.add_argument("--chunks", type=int, default=4)
    ap.add_argument("--plain", action="store_true", help="measure on the per-step regeneration path")
    ap.add_argument("--from-reset", action="store_true", help="start the chain at a reset")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = torch.device(args.device)
    configs = [(args.env, args.num_envs)] if args.env else list(CONFIGS)
    for env_id, n in configs:
        out = measure(env_id, n, args.num_steps, args.chunks, args.plain, device, from_reset=args.from_reset)
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
