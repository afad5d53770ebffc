"""Batched lockstep rollouts.

Counterpart of ``minigrid_tpu/parallel/vector.py``: the batch is the leading
tensor axis, time is a loop (or, on the fused path, the kernel's own loop),
and auto-reset is fused into the step.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core.env import cached_autoreset
from minigrid_tpu_torch.core.state import resolve_device, select
from minigrid_tpu_torch.ops.fused_rollout import compiled_ext, fused_rollout, supports_fused
from minigrid_tpu_torch.parallel.reset_budget import check_pool, chunk_resets, pool_size

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


def make_pool_stepper(env, pool, num_envs: int):
    """Batched ``step_env`` with the auto-resets drawn from ONE shared pool
    of fresh levels in global episode order (the JAX package's
    ``make_pool_stepper``, ``minigrid_tpu/parallel/vector.py:59-105``).

    ``pool`` holds P pre-generated levels (leaves [P, ...], ``extra``
    included).  Each step ranks this step's ended episodes by env index
    (a cumulative sum) and hands them consecutive pool rows from the
    running ``consumed`` count on, so no row serves two episodes: the
    reference's fresh level at every reset (minigrid/minigrid_env.py:
    119-143), where the pool need only cover the chunk's total episode
    count (``reset_budget.pool_size``), not every env's maximum.  Past P the
    row index clamps at P-1 and ``consumed`` exceeds P, which callers check
    (``reset_budget.check_pool``; ``rollout_random`` does).

    Returns ``step(states, actions, consumed) -> (states, reward,
    terminated, truncated, consumed)`` with ``consumed`` a scalar int32
    tensor."""
    size = pool.step_count.shape[0]

    def step(states, actions, consumed):
        stepped, reward = env.step_env(states, actions)
        done = stepped.terminated | stepped.truncated
        ended = done.to(torch.int32)
        slot = consumed + ended.cumsum(0, dtype=torch.int32) - 1  # this step's global ranks
        rows = slot.clamp(0, size - 1).long()
        fresh = pool.map(lambda a: a[rows])
        consumed = consumed + ended.sum(dtype=torch.int32)
        return select(done, fresh, stepped), reward, stepped.terminated, stepped.truncated, consumed

    return step


def batch_reset_pool(env, generator: torch.Generator | None, size: int, device=None):
    """``size`` fresh iid levels (leaves [size, ...]): the shared pool of
    ``make_pool_stepper``, drawn through the family's reset-cache generator
    (``minigrid_tpu/parallel/vector.py:108-113``)."""
    cache = env.batch_reset_cache(size, 1, generator, device)
    return cache.map(lambda a: a[:, 0])


def plain_pool_size(env, num_steps: int, num_envs: int, resets_per_chunk: int | None = None, env_id=None) -> int:
    """The shared pool of the plain path for ``num_envs`` x ``num_steps``:
    ``num_envs * resets_per_chunk`` levels where the caller gives a per-env
    budget, else ``reset_budget.pool_size`` from the measured mean episode
    rate.  (The JAX package ignores an explicit ``resets_per_chunk`` here.)"""
    if resets_per_chunk is not None:
        return num_envs * int(resets_per_chunk)
    return pool_size(env, num_steps, num_envs, env_id)


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
    the cached exts, BabyAI's with its two planes) and at most
    ``MAX_FUSED_CELLS`` grid cells.  The view does not gate it, as it does
    not gate the JAX package's kernel: any odd view from 3 to 31 runs
    (another view size than 7 built at its first launch), and the kernel
    raises for a wider one.  The kernel keeps the reset cache in device
    memory, so R does not gate it."""
    return (
        torch.device(device).type == "cuda"
        and supports_fused(env)
        and compiled_ext(env)
        and env.width * env.height <= MAX_FUSED_CELLS
    )


def rollout_capacity(
    env,
    num_steps: int,
    device,
    env_id: str | None = None,
    fused="auto",
    num_envs: int | None = None,
    resets_per_chunk: int | None = None,
) -> int:
    """The reset budget that ``rollout_random`` enforces for this
    configuration, which its ``max_used`` must stay within for a certified
    replay-free rollout (the JAX package's rule,
    ``minigrid_tpu/parallel/vector.py:164-182``, with the 256-step R for
    short chunks): the per-env covering R on the fused path
    (``resets_per_chunk`` where given, else ``reset_budget.chunk_resets``; a
    counter-reset family's ``max_used`` is 0 there), the shared pool's size
    on the plain
    path of an ``expensive_reset`` family (``plain_pool_size``, which needs
    ``num_envs``), and 0 on the per-step regeneration path, where nothing
    runs out."""
    if fused == "auto":
        fused = fused_eligible(env, device)
    if fused:
        return chunk_resets(env, num_steps, env_id) if resets_per_chunk is None else int(resets_per_chunk)
    if env.expensive_reset:
        if num_envs is None:
            raise ValueError("the shared pool's capacity depends on num_envs: pass it")
        return plain_pool_size(env, num_steps, num_envs, resets_per_chunk, env_id)
    return 0


def rollout_random(
    env,
    states,
    generator: torch.Generator | None,
    num_steps: int,
    resets_per_chunk: int | None = None,
    fused="auto",
    check: bool = True,
):
    """``num_steps`` uniform-random steps of every env in ``states``.

    Returns (final_states, total_reward, episodes_finished, max_used):
    ``max_used`` counts the reset budget consumed, the most reset-cache
    slots an env used on the fused path, the shared-pool rows consumed on
    the plain path of an ``expensive_reset`` family, and 0 on the per-step
    regeneration path.  ``max_used <= rollout_capacity(...)`` certifies the
    chunk replay-free.  ``fused="auto"`` takes the CUDA kernel where
    ``fused_eligible`` says it runs, with a per-env cache of R =
    ``resets_per_chunk`` levels (``reset_budget.chunk_resets`` where None:
    the 256-step R for any chunk of up to 256 steps; a counter-reset family
    has no cache).  Otherwise every step is the batched
    ``step_env``: an ``expensive_reset`` family draws its resets from one
    shared pool (``make_pool_stepper``, sized by ``plain_pool_size``, drawn
    from ``generator`` before the first step; ``AssertionError`` where the
    chunk ran it out, one host read at the end, unless ``check=False``, as
    ``parallel/mesh`` asks, which checks after reducing over the ranks), the
    others regenerate every ended episode's level at every step.
    """
    if fused == "auto":
        fused = fused_eligible(env, states.device)
    if fused:
        if resets_per_chunk is None:
            resets_per_chunk = chunk_resets(env, num_steps)
        final, total_r, total_done, _, max_used = fused_rollout(
            env, states, generator, num_steps, resets_per_chunk, compute_obs=False
        )
        return final, total_r, total_done, max_used

    n, device = states.step_count.shape[0], states.device
    total_r = torch.zeros((), dtype=torch.float32, device=device)
    total_done = torch.zeros((), dtype=torch.int64, device=device)
    consumed = torch.zeros((), dtype=torch.int32, device=device)
    if env.expensive_reset:
        size = plain_pool_size(env, num_steps, n, resets_per_chunk)
        step = make_pool_stepper(env, batch_reset_pool(env, generator, size, device), n)
    for _ in range(num_steps):
        actions = torch.randint(
            0, env.num_actions, (n,), generator=generator, device=device, dtype=torch.int32
        )
        if env.expensive_reset:
            states, reward, terminated, truncated, consumed = step(states, actions, consumed)
        else:
            stepped, reward = env.step_env(states, actions)
            states = env.autoreset(stepped, generator)
            terminated, truncated = stepped.terminated, stepped.truncated
        total_r = total_r + reward.sum()
        total_done = total_done + (terminated | truncated).sum()
    if env.expensive_reset and check:
        check_pool(int(consumed), size)
    return states, total_r, total_done.to(torch.int32), consumed
