"""Covering sizes for the per-chunk reset cache.

The reference generates a fresh level at every episode end
(minigrid/minigrid_env.py:119-143).  Batched rollouts draw resets from a
cache of R pre-generated levels per env, and the r-th episode end of a chunk
takes slot min(r, R-1): that equals the reference's stream exactly while no
env ends more than R episodes in the chunk.  This module sizes R, with the
same tables and rules as ``minigrid_tpu/parallel/reset_budget.py``:

* ``deterministic_generation`` families (fixed-start Empty) need R=1, since
  every fresh level is the same;
* the others size R from the measured per-env episode maximum, with margin;
  a learner's chunk shorter than 256 steps takes the 256-step R
  (``learner_resets``);
* callers check: the rollouts return the consumed-slot maximum and
  ``assert_chain_covered`` fails a run that went past R.
"""

from __future__ import annotations

import math

# Maximum episodes any env finished in one 256-step chunk under a uniform
# random policy, chained steady state, keyed by registry id.  Episode counts
# do not depend on the hardware.  The first rows are the JAX package's
# (measured there with its tools/measure_reset_budget.py), but where this
# package's tools/measure_reset_budget.py, on an NVIDIA H100 80GB HBM3 at a
# 700.00 W power limit, measured more over 32 chunks chained from spread
# episode ages (65536 envs, 16384 for BabyAI): FourRooms 6 (JAX's row 5)
# and GoToLocal 12 (JAX's row 11).  The same measurement confirmed DoorKey-8x8
# (2) and GoTo (5).
MEASURED_MAX_EPISODES_256: dict[str, int] = {
    "MiniGrid-Empty-Random-5x5-v0": 12,
    "MiniGrid-FourRooms-v0": 6,
    "MiniGrid-DoorKey-8x8-v0": 2,
    "MiniGrid-LavaCrossingS9N2-v0": 18,
    "MiniGrid-Dynamic-Obstacles-8x8-v0": 37,
    "BabyAI-GoToLocal-v0": 12,
    "MiniGrid-ObstructedMaze-2Dlh-v0": 2,
    # Entered as 5 in the JAX package for want of a full-scale measurement;
    # this package measured 4 over 8 chunks and 5 over 32.
    "BabyAI-GoTo-v0": 5,
    # This package's rows, which the JAX table lacks: its
    # tools/measure_reset_budget.py through the whole-rollout kernel on an
    # NVIDIA H100 80GB HBM3 (700.00 W power limit), 65536 envs, the maximum
    # over 8 chunks: 4 chained from spread episode ages (its default), 4
    # from a reset (--from-reset); GoToObject-8x8-N2 and Fetch-8x8-N3 raised
    # to the maximum over 32 chunks from spread episode ages (GoToDoor-8x8
    # measured 109 there).
    # GoToObject and GoToDoor end an episode on every done or toggle.
    "MiniGrid-GoToObject-6x6-N2-v0": 107,
    "MiniGrid-GoToObject-8x8-N2-v0": 112,
    "MiniGrid-GoToDoor-5x5-v0": 105,
    "MiniGrid-GoToDoor-6x6-v0": 105,
    "MiniGrid-GoToDoor-8x8-v0": 113,
    "MiniGrid-Fetch-5x5-N2-v0": 17,
    "MiniGrid-Fetch-6x6-N2-v0": 16,
    "MiniGrid-Fetch-8x8-N3-v0": 13,
    # The classic zoo's last slice: the same tool on an NVIDIA H100 80GB
    # HBM3 (700.00 W power limit), 32 chunks chained from spread episode
    # ages, at chip_smoke.py's sizes (8192 envs for ObstructedMaze, 16384
    # for LockedRoom, Playground and MultiRoom, 65536 for the rest).  It
    # measured ObstructedMaze-2Dlh at JAX's 2.  PutNear ends an episode at
    # every drop attempt and wrong pickup.
    "MiniGrid-ObstructedMaze-Full-v1": 1,
    "MiniGrid-Unlock-v0": 4,
    "MiniGrid-BlockedUnlockPickup-v0": 2,
    "MiniGrid-KeyCorridorS3R3-v0": 2,
    "MiniGrid-KeyCorridorS6R3-v0": 1,
    "MiniGrid-DistShift1-v0": 15,
    "MiniGrid-LavaGapS7-v0": 18,
    "MiniGrid-MemoryS17Random-v0": 8,
    "MiniGrid-PutNear-8x8-N3-v0": 14,
    "MiniGrid-RedBlueDoors-8x8-v0": 6,
    "MiniGrid-LockedRoom-v0": 2,
    "MiniGrid-Playground-v0": 3,
    "MiniGrid-MultiRoom-N6-v0": 3,
    # The rest of BabyAI: the same tool on an NVIDIA H100 80GB HBM3 (700.00 W
    # power limit), 16384 envs, 8 chunks chained from spread episode ages,
    # 32 for BossLevel and for the ids whose maximum over 8 came within 2 of
    # the fallback (the Debug ids, OpenRedDoor, PickupLoc, PickupDist,
    # PutNextLocalS5N3, the Carrying ids S5N2 and S6N3, ActionObjDoor,
    # OneRoomS8, GoToSeqS5R2, SynthS5R2).  A strict leaf ends an episode at a
    # wrong toggle or pickup.
    "BabyAI-Open-v0": 4,
    "BabyAI-OpenRedDoor-v0": 10,
    "BabyAI-OpenDoor-v0": 5,
    "BabyAI-OpenDoorDebug-v0": 8,
    "BabyAI-OpenDoorColor-v0": 5,
    "BabyAI-OpenDoorLoc-v0": 5,
    "BabyAI-OpenTwoDoors-v0": 3,
    "BabyAI-OpenRedBlueDoors-v0": 3,
    "BabyAI-OpenRedBlueDoorsDebug-v0": 5,
    "BabyAI-OpenDoorsOrderN2-v0": 4,
    "BabyAI-OpenDoorsOrderN4-v0": 4,
    "BabyAI-OpenDoorsOrderN2Debug-v0": 7,
    "BabyAI-OpenDoorsOrderN4Debug-v0": 11,
    "BabyAI-Pickup-v0": 5,
    "BabyAI-UnblockPickup-v0": 3,
    "BabyAI-PickupLoc-v0": 9,
    "BabyAI-PickupDist-v0": 11,
    "BabyAI-PickupDistDebug-v0": 16,
    "BabyAI-PickupAbove-v0": 3,
    "BabyAI-PutNextLocal-v0": 4,
    "BabyAI-PutNextLocalS5N3-v0": 7,
    "BabyAI-PutNextLocalS6N4-v0": 5,
    "BabyAI-PutNextS4N1-v0": 5,
    "BabyAI-PutNextS5N2-v0": 3,
    "BabyAI-PutNextS5N1-v0": 4,
    "BabyAI-PutNextS6N3-v0": 2,
    "BabyAI-PutNextS7N4-v0": 2,
    "BabyAI-PutNextS5N2Carrying-v0": 8,
    "BabyAI-PutNextS6N3Carrying-v0": 7,
    "BabyAI-PutNextS7N4Carrying-v0": 5,
    "BabyAI-Unlock-v0": 3,
    "BabyAI-UnlockLocal-v0": 2,
    "BabyAI-UnlockLocalDist-v0": 2,
    "BabyAI-KeyInBox-v0": 2,
    "BabyAI-UnlockPickup-v0": 4,
    "BabyAI-UnlockPickupDist-v0": 4,
    "BabyAI-BlockedUnlockPickup-v0": 2,
    "BabyAI-UnlockToUnlock-v0": 1,
    "BabyAI-ActionObjDoor-v0": 8,
    "BabyAI-FindObjS5-v0": 4,
    "BabyAI-FindObjS6-v0": 3,
    "BabyAI-FindObjS7-v0": 3,
    "BabyAI-KeyCorridor-v0": 1,
    "BabyAI-KeyCorridorS3R1-v0": 2,
    "BabyAI-KeyCorridorS3R2-v0": 2,
    "BabyAI-KeyCorridorS3R3-v0": 2,
    "BabyAI-KeyCorridorS4R3-v0": 2,
    "BabyAI-KeyCorridorS5R3-v0": 1,
    "BabyAI-KeyCorridorS6R3-v0": 1,
    "BabyAI-OneRoomS8-v0": 10,
    "BabyAI-OneRoomS12-v0": 5,
    "BabyAI-OneRoomS16-v0": 4,
    "BabyAI-OneRoomS20-v0": 4,
    "BabyAI-MoveTwoAcrossS5N2-v0": 2,
    "BabyAI-MoveTwoAcrossS8N9-v0": 1,
    "BabyAI-GoToSeq-v0": 4,
    "BabyAI-GoToSeqS5R2-v0": 7,
    "BabyAI-Synth-v0": 4,
    "BabyAI-SynthS5R2-v0": 7,
    "BabyAI-SynthLoc-v0": 5,
    "BabyAI-SynthSeq-v0": 3,
    "BabyAI-MiniBossLevel-v0": 5,
    "BabyAI-BossLevel-v0": 4,
    "BabyAI-BossLevelNoUnlock-v0": 3,
    # WFC's six presets (25x25): `python -m minigrid_tpu_torch.tools.
    # measure_reset_budget --env MiniGrid-WFC-<preset>-v0 --num-envs 16384
    # --chunks 32` on an NVIDIA H100 80GB HBM3 (700.00 W power limit),
    # chained from spread episode ages, every chunk certified at the tool's
    # first R (10-14).  A random walk rarely reaches the goal of a 23x23
    # maze, but start and goal can lie a step apart, and the 500-step limit
    # ends an episode at most once a chunk.
    "MiniGrid-WFC-MazeSimple-v0": 4,
    "MiniGrid-WFC-DungeonMazeScaled-v0": 4,
    "MiniGrid-WFC-RoomsFabric-v0": 4,
    "MiniGrid-WFC-ObstaclesBlackdots-v0": 4,
    "MiniGrid-WFC-ObstaclesAngular-v0": 4,
    "MiniGrid-WFC-ObstaclesHogs3-v0": 4,
}

# Fallback for ids without a measured entry; deliberately generous.
_FALLBACK_EPISODES_256 = 8

# Mean episodes per env per 256-step chunk (same runs); sizes a shared pool
# of levels drawn in global episode order.
MEASURED_MEAN_EPISODES_256: dict[str, float] = {
    "MiniGrid-Empty-Random-5x5-v0": 3.58,
    "MiniGrid-FourRooms-v0": 2.55,
    "MiniGrid-DoorKey-8x8-v0": 0.38,
    "MiniGrid-LavaCrossingS9N2-v0": 3.68,
    "MiniGrid-Dynamic-Obstacles-8x8-v0": 14.28,
    "BabyAI-GoToLocal-v0": 4.67,
    "MiniGrid-ObstructedMaze-2Dlh-v0": 0.38,
    "BabyAI-GoTo-v0": 1.0,
    # This package's rows (the 4 chunks from spread episode ages of the runs
    # above).
    "MiniGrid-GoToObject-6x6-N2-v0": 73.16,
    "MiniGrid-GoToObject-8x8-N2-v0": 73.17,
    "MiniGrid-GoToDoor-5x5-v0": 73.15,
    "MiniGrid-GoToDoor-6x6-v0": 73.15,
    "MiniGrid-GoToDoor-8x8-v0": 73.15,
    "MiniGrid-Fetch-5x5-N2-v0": 4.89,
    "MiniGrid-Fetch-6x6-N2-v0": 3.06,
    "MiniGrid-Fetch-8x8-N3-v0": 2.0,
    # The classic zoo's last slice (the 32-chunk runs above;
    # ObstructedMaze-2Dlh measured 0.446 against JAX's 0.38 here).
    "MiniGrid-ObstructedMaze-Full-v1": 0.0719,
    "MiniGrid-Unlock-v0": 0.9072,
    "MiniGrid-BlockedUnlockPickup-v0": 0.4448,
    "MiniGrid-KeyCorridorS3R3-v0": 0.9487,
    "MiniGrid-KeyCorridorS6R3-v0": 0.237,
    "MiniGrid-DistShift1-v0": 2.7319,
    "MiniGrid-LavaGapS7-v0": 3.4044,
    "MiniGrid-MemoryS17Random-v0": 0.3741,
    "MiniGrid-PutNear-8x8-N3-v0": 7.3631,
    "MiniGrid-RedBlueDoors-8x8-v0": 0.3065,
    "MiniGrid-LockedRoom-v0": 1.3473,
    "MiniGrid-Playground-v0": 2.5601,
    "MiniGrid-MultiRoom-N6-v0": 2.1333,
    # The rest of BabyAI (the runs above).
    "BabyAI-Open-v0": 0.494,
    "BabyAI-OpenRedDoor-v0": 5.5051,
    "BabyAI-OpenDoor-v0": 0.5835,
    "BabyAI-OpenDoorDebug-v0": 1.0001,
    "BabyAI-OpenDoorColor-v0": 0.5443,
    "BabyAI-OpenDoorLoc-v0": 0.6267,
    "BabyAI-OpenTwoDoors-v0": 0.3851,
    "BabyAI-OpenRedBlueDoors-v0": 0.3851,
    "BabyAI-OpenRedBlueDoorsDebug-v0": 0.5974,
    "BabyAI-OpenDoorsOrderN2-v0": 0.4392,
    "BabyAI-OpenDoorsOrderN4-v0": 0.4261,
    "BabyAI-OpenDoorsOrderN2Debug-v0": 0.9715,
    "BabyAI-OpenDoorsOrderN4Debug-v0": 1.912,
    "BabyAI-Pickup-v0": 0.4799,
    "BabyAI-UnblockPickup-v0": 0.4825,
    "BabyAI-PickupLoc-v0": 4.3357,
    "BabyAI-PickupDist-v0": 5.7198,
    "BabyAI-PickupDistDebug-v0": 7.1567,
    "BabyAI-PickupAbove-v0": 0.9043,
    "BabyAI-PutNextLocal-v0": 2.0076,
    "BabyAI-PutNextLocalS5N3-v0": 5.1629,
    "BabyAI-PutNextLocalS6N4-v0": 3.5799,
    "BabyAI-PutNextS4N1-v0": 2.0494,
    "BabyAI-PutNextS5N2-v0": 1.2898,
    "BabyAI-PutNextS5N1-v0": 1.2922,
    "BabyAI-PutNextS6N3-v0": 0.8917,
    "BabyAI-PutNextS7N4-v0": 0.6538,
    "BabyAI-PutNextS5N2Carrying-v0": 1.5077,
    "BabyAI-PutNextS6N3Carrying-v0": 0.9852,
    "BabyAI-PutNextS7N4Carrying-v0": 0.7056,
    "BabyAI-Unlock-v0": 0.4593,
    "BabyAI-UnlockLocal-v0": 0.4496,
    "BabyAI-UnlockLocalDist-v0": 0.4487,
    "BabyAI-KeyInBox-v0": 0.4488,
    "BabyAI-UnlockPickup-v0": 3.5567,
    "BabyAI-UnlockPickupDist-v0": 3.5561,
    "BabyAI-BlockedUnlockPickup-v0": 0.4451,
    "BabyAI-UnlockToUnlock-v0": 0.2373,
    "BabyAI-ActionObjDoor-v0": 0.8987,
    "BabyAI-FindObjS5-v0": 0.563,
    "BabyAI-FindObjS6-v0": 0.3875,
    "BabyAI-FindObjS7-v0": 0.2837,
    "BabyAI-KeyCorridor-v0": 0.2374,
    "BabyAI-KeyCorridorS3R1-v0": 0.9613,
    "BabyAI-KeyCorridorS3R2-v0": 0.9494,
    "BabyAI-KeyCorridorS3R3-v0": 0.9495,
    "BabyAI-KeyCorridorS4R3-v0": 0.5347,
    "BabyAI-KeyCorridorS5R3-v0": 0.3417,
    "BabyAI-KeyCorridorS6R3-v0": 0.2374,
    "BabyAI-OneRoomS8-v0": 4.294,
    "BabyAI-OneRoomS12-v0": 1.8955,
    "BabyAI-OneRoomS16-v0": 1.0614,
    "BabyAI-OneRoomS20-v0": 0.6769,
    "BabyAI-MoveTwoAcrossS5N2-v0": 0.6404,
    "BabyAI-MoveTwoAcrossS8N9-v0": 0.25,
    "BabyAI-GoToSeq-v0": 0.2531,
    "BabyAI-GoToSeqS5R2-v0": 1.4238,
    "BabyAI-Synth-v0": 0.4134,
    "BabyAI-SynthS5R2-v0": 1.6185,
    "BabyAI-SynthLoc-v0": 0.4189,
    "BabyAI-SynthSeq-v0": 0.2169,
    "BabyAI-MiniBossLevel-v0": 1.195,
    "BabyAI-BossLevel-v0": 0.2009,
    "BabyAI-BossLevelNoUnlock-v0": 0.2132,
    # WFC (the runs above).
    "MiniGrid-WFC-MazeSimple-v0": 0.5412,
    "MiniGrid-WFC-DungeonMazeScaled-v0": 0.5463,
    "MiniGrid-WFC-RoomsFabric-v0": 0.5313,
    "MiniGrid-WFC-ObstaclesBlackdots-v0": 0.5295,
    "MiniGrid-WFC-ObstaclesAngular-v0": 0.5410,
    "MiniGrid-WFC-ObstaclesHogs3-v0": 0.5287,
}


def pool_size(env, num_steps: int, num_envs: int, env_id: str | None = None) -> int:
    """Shared-pool capacity covering the aggregate episode count of one
    ``num_envs`` x ``num_steps`` chunk: the measured mean with a 30% margin
    plus a 6-sigma binomial term.  Ids without a measured mean fall back to
    the per-env covering R of ``chunk_resets`` (the JAX package scales it
    down for short chunks)."""
    if env_id is None:
        env_id = getattr(env, "env_id", None)
    mean = MEASURED_MEAN_EPISODES_256.get(env_id)
    if mean is None:
        return num_envs * chunk_resets(env, num_steps, env_id)
    agg = num_envs * mean * max(num_steps, 1) / 256
    return int(math.ceil(agg * 1.3 + 6 * math.sqrt(agg + 1) + 64))


def covering_resets(measured_max: int, num_steps: int) -> int:
    """Covering R for a ``num_steps`` chunk from the measured per-256-step
    maximum: scaled to the chunk, plus a 25% + 2 margin."""
    scaled = math.ceil(measured_max * max(num_steps, 1) / 256)
    return scaled + max(math.ceil(scaled / 4), 2)


def resets_for(env, num_steps: int, env_id: str | None = None) -> int:
    """Covering resets per chunk for ``env``; 1 for
    ``deterministic_generation`` families.  ``env_id`` defaults to the id
    ``make`` stamped on the instance."""
    if getattr(env, "deterministic_generation", False):
        return 1
    if env_id is None:
        env_id = getattr(env, "env_id", None)
    measured = MEASURED_MAX_EPISODES_256.get(env_id, _FALLBACK_EPISODES_256)
    return covering_resets(measured, num_steps)


def chunk_resets(env, num_steps: int, env_id: str | None = None) -> int:
    """Covering resets for a chunk of ``num_steps``: the 256-step rule, not
    scaled down, for any chunk of up to 256 steps.  A shorter window lies
    inside some 256-step chunk, so the 256-step maximum bounds its
    episodes, where the linear scaling of ``resets_for`` does not
    (Fetch-8x8-N3 ended 9 episodes in a 128-step chunk against a scaled R
    of 8, and one of 64 GoToDoor-5x5 envs 10 in a 16-step chunk against
    9).  Longer chunks scale as ``resets_for`` does."""
    return resets_for(env, max(num_steps, 256), env_id)


def learner_resets(env, rollout_steps: int) -> int:
    """Covering resets for a learner's chunk of ``rollout_steps``
    (``chunk_resets``).  The rows come from a uniform random policy and a
    learning one may end episodes faster, so the learners report
    ``max_episodes_per_chunk`` to hold against it."""
    return chunk_resets(env, rollout_steps)


def check_pool(consumed: int, size: int) -> None:
    """Raise where a chunk consumed more than the ``size`` levels of its
    shared pool (``parallel/vector.make_pool_stepper``), which then served
    its last level again."""
    if consumed > size:
        raise AssertionError(
            f"reset pool exhausted: a chunk consumed {consumed} pool levels but the pool holds {size}, "
            "so levels were replayed, which the reference's reset contract forbids.  Raise this id's entry "
            "in MEASURED_MEAN_EPISODES_256, or pass a larger resets_per_chunk."
        )


def assert_chain_covered(step, carry, resets: int, env, chunks: int = 8, pool: bool = False) -> int:
    """Run ``chunks`` chained calls of ``step`` (``carry -> (carry, live)``,
    the consumed budget being the last element of ``live``) and assert that
    no chunk consumed more than ``resets``: cache slots of an env, or with
    ``pool=True`` rows of the shared pool (``parallel/vector.
    make_pool_stepper``).  ``deterministic_generation`` families are exempt.
    Returns the observed maximum."""
    if getattr(env, "deterministic_generation", False):
        return 0
    observed = 0
    for _ in range(chunks):
        carry, live = step(carry)
        observed = max(observed, int(live[-1]))
    if observed > resets:
        if pool:
            check_pool(observed, resets)
        raise AssertionError(
            f"reset cache exhausted: an env consumed {observed} slots in one chunk "
            f"but R={resets}, so levels were replayed, which the reference's reset "
            "contract forbids.  Raise this id's entry in MEASURED_MAX_EPISODES_256."
        )
    return observed
