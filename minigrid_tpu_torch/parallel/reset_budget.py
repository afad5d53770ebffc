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
* callers check: the rollouts return the consumed-slot maximum and
  ``assert_chain_covered`` fails a run that went past R.
"""

from __future__ import annotations

import math

# Maximum episodes any env finished in one 256-step chunk under a uniform
# random policy, chained steady state, keyed by registry id.  Episode counts
# do not depend on the hardware; the values are those of the JAX package
# (measured there with tools/measure_reset_budget.py).
MEASURED_MAX_EPISODES_256: dict[str, int] = {
    "MiniGrid-Empty-Random-5x5-v0": 12,
    "MiniGrid-FourRooms-v0": 5,
    "MiniGrid-DoorKey-8x8-v0": 2,
    "MiniGrid-LavaCrossingS9N2-v0": 18,
    "MiniGrid-Dynamic-Obstacles-8x8-v0": 37,
    "BabyAI-GoToLocal-v0": 11,
    "MiniGrid-ObstructedMaze-2Dlh-v0": 2,
    # An estimate, not a full-scale measurement (ROADMAP.md open questions).
    "BabyAI-GoTo-v0": 5,
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
}


def pool_size(env, num_steps: int, num_envs: int, env_id: str | None = None) -> int:
    """Shared-pool capacity covering the aggregate episode count of one
    ``num_envs`` x ``num_steps`` chunk: the measured mean with a 30% margin
    plus a 6-sigma binomial term.  Ids without a measured mean fall back to
    the per-env covering R."""
    if env_id is None:
        env_id = getattr(env, "env_id", None)
    mean = MEASURED_MEAN_EPISODES_256.get(env_id)
    if mean is None:
        return num_envs * resets_for(env, num_steps, env_id)
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


def assert_chain_covered(step, carry, resets: int, env, chunks: int = 8) -> int:
    """Run ``chunks`` chained calls of ``step`` (``carry -> (carry, live)``,
    the consumed-slot maximum being the last element of ``live``) and assert
    that no chunk consumed more than ``resets`` cache slots.
    ``deterministic_generation`` families are exempt.  Returns the observed
    maximum."""
    if getattr(env, "deterministic_generation", False):
        return 0
    observed = 0
    for _ in range(chunks):
        carry, live = step(carry)
        observed = max(observed, int(live[-1]))
    if observed > resets:
        raise AssertionError(
            f"reset cache exhausted: an env consumed {observed} slots in one chunk "
            f"but R={resets}, so levels were replayed, which the reference's reset "
            "contract forbids.  Raise this id's entry in MEASURED_MAX_EPISODES_256."
        )
    return observed
