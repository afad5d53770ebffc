"""Batched lockstep rollouts.

Counterpart of ``minigrid_tpu/parallel/vector.py``: the batch is the leading
tensor axis, time is a loop (or, on the fused path, the kernel's own loop),
and auto-reset is fused into the step.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core.env import cached_autoreset
from minigrid_tpu_torch.core.state import resolve_device
from minigrid_tpu_torch.ops.fused_rollout import COMPILED_VIEW_SIZES, compiled_ext, fused_rollout, supports_fused
from minigrid_tpu_torch.parallel.reset_budget import resets_for

# Largest grid the kernel takes (MultiRoom-scale 25x25), as in the JAX gate.
MAX_FUSED_CELLS = 625


def make_cached_stepper(env, cache, num_envs: int):
    """Batched ``step_cached`` without the observation (the JAX package's
    ``make_cached_stepper``, ``minigrid_tpu/parallel/vector.py:17-56``): an
    ending episode takes slot min(used, R-1) of its env's reset ``cache``
    (leaves [num_envs, R, ...], ``extra`` included), then ``used`` grows by
    one.  The JAX package packs the cache into one buffer to work around
    the TPU's gathers; here the slot is plain indexing.

    Returns ``step(states, actions, used) -> (states, reward, terminated,
    truncated, used)``."""
    if cache.step_count.shape[0] != num_envs:
        raise ValueError(f"the cache holds {cache.step_count.shape[0]} envs, not {num_envs}")

    def step(states, actions, used):
        stepped, reward = env.step_env(states, actions)
        states, used = cached_autoreset(stepped, cache, used)
        return states, reward, stepped.terminated, stepped.truncated, used

    return step


class VectorEnv:
    """Lockstep batch of ``num_envs`` copies of one env family, on
    ``device`` (CUDA unless given)."""

    def __init__(self, env, num_envs: int, device=None):
        self.env = env
        self.num_envs = int(num_envs)
        self.device = resolve_device(None, device)

    def reset(self, generator: torch.Generator | None = None):
        return self.env.reset(self.num_envs, generator, self.device)

    def step(self, states, actions, generator: torch.Generator | None = None):
        return self.env.step(states, actions, generator)


def fused_eligible(env, device) -> bool:
    """Whether the whole-rollout CUDA kernel (ops/fused_rollout.py) runs this
    configuration: a CUDA device, a default-hook family or one whose fused
    ext the kernel has compiled (``compiled_ext``: the counter-reset and
    the cached exts, BabyAI's with its two planes), at most
    ``MAX_FUSED_CELLS`` grid cells and a compiled view size.  The kernel
    keeps the reset cache in device memory, so R does not gate it."""
    return (
        torch.device(device).type == "cuda"
        and supports_fused(env)
        and compiled_ext(env)
        and env.width * env.height <= MAX_FUSED_CELLS
        and env.agent_view_size in COMPILED_VIEW_SIZES
    )


def rollout_capacity(env, num_steps: int, device, env_id: str | None = None, fused="auto") -> int:
    """The reset budget ``max_used`` must stay within for a certified
    replay-free rollout: the per-env covering R on the fused path (as the
    JAX package's rule, ``minigrid_tpu/parallel/vector.py:164-182``; a
    counter-reset family's ``max_used`` is 0 there), 0 on the per-step
    regeneration path (where the cache cannot run out).  The JAX package's
    shared-pool path for ``expensive_reset`` families is not ported: the
    plain path here regenerates at every step."""
    if fused == "auto":
        fused = fused_eligible(env, device)
    return resets_for(env, num_steps, env_id) if fused else 0


def rollout_random(
    env,
    states,
    generator: torch.Generator | None,
    num_steps: int,
    resets_per_chunk: int | None = None,
    fused="auto",
):
    """``num_steps`` uniform-random steps of every env in ``states``.

    Returns (final_states, total_reward, episodes_finished, max_used), where
    ``max_used`` is the most reset-cache slots an env consumed on the fused
    path and 0 on the per-step path.  ``fused="auto"`` takes the CUDA kernel
    where ``fused_eligible`` says it runs; otherwise every step is the
    batched ``step_env`` with per-step auto-reset.  ``resets_per_chunk=None``
    sizes the cache with ``reset_budget.resets_for`` (a counter-reset
    family has no cache and ignores it).
    """
    if resets_per_chunk is None:
        resets_per_chunk = resets_for(env, num_steps)
    if fused == "auto":
        fused = fused_eligible(env, states.device)
    if fused:
        final, total_r, total_done, _, max_used = fused_rollout(
            env, states, generator, num_steps, resets_per_chunk, compute_obs=False
        )
        return final, total_r, total_done, max_used

    n, device = states.step_count.shape[0], states.device
    total_r = torch.zeros((), dtype=torch.float32, device=device)
    total_done = torch.zeros((), dtype=torch.int64, device=device)
    for _ in range(num_steps):
        actions = torch.randint(
            0, env.num_actions, (n,), generator=generator, device=device, dtype=torch.int32
        )
        stepped, reward = env.step_env(states, actions)
        states = env.autoreset(stepped, generator)
        total_r = total_r + reward.sum()
        total_done = total_done + (stepped.terminated | stepped.truncated).sum()
    return states, total_r, total_done.to(torch.int32), torch.zeros((), dtype=torch.int32, device=device)
