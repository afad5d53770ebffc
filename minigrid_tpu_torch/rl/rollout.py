"""On-policy trajectory collection for the learners.

Counterpart of ``minigrid_tpu/rl/rollout.py``.  Trajectories are time-major,
with the observation as the packed int32 [T, N, v*v] view
(``MiniGridEnv.observation_packed``), which ``rl/model.embed_obs_packed``
embeds to the same features as the uint8 image.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from minigrid_tpu_torch.ops.actor_rollout import (
    draw_bits,
    fused_actor_rollout,
    sample_actions,
)
from minigrid_tpu_torch.ops.fused_rollout import counter_reset
from minigrid_tpu_torch.parallel.mesh import all_reduce
from minigrid_tpu_torch.parallel.reset_budget import learner_resets
from minigrid_tpu_torch.parallel.vector import make_cached_stepper


class LearnerResets:
    """The R of a learner's reset cache, grown from what its chunks end.

    The first chunk takes ``resets_per_chunk`` where the caller gives one,
    which then stays fixed, else ``reset_budget.learner_resets``, whose rows
    a uniform random policy measured; a learning policy may end episodes
    faster.  ``observe(done)`` reads a collected chunk (bool [T, N]) and
    returns its metrics: ``max_episodes_per_chunk``, the ``resets_per_chunk``
    it was drawn at and ``replayed``, the resets that went past R (each of
    an env's episodes beyond R replayed the cache's last slot).  Where the
    chunk's maximum comes within a margin of R (above R - max(2, R // 4)),
    the next chunk draws max(2 * maximum, R + 1) levels.  A family that
    cannot replay a level (a counter-reset family has no cache, and a
    deterministic one's levels are all alike) keeps its R and reports 0.
    On a mesh (``parallel/mesh``), ``observe(done, mesh)`` takes the maximum
    over the ranks (one all-reduce) and sums ``replayed`` (another) before R
    grows, so every rank's R stays the same.
    """

    def __init__(self, env, rollout_steps: int, resets_per_chunk: int | None = None):
        self.fixed = resets_per_chunk is not None
        self.r = resets_per_chunk if self.fixed else learner_resets(env, rollout_steps)
        self.can_replay = not counter_reset(env) and not env.deterministic_generation

    def observe(self, done: torch.Tensor, mesh=None) -> dict[str, torch.Tensor]:
        episodes = done.int().sum(dim=0)
        most = episodes.max()
        r = self.r
        replayed = (episodes - r).clamp(min=0).sum() if self.can_replay else torch.zeros_like(most)
        if mesh is not None:
            # Every rank's chunk is one of the same run: R grows from the
            # most of any rank, so that the ranks keep one R.
            most = all_reduce(mesh, most, "max")
            replayed = all_reduce(mesh, replayed.int(), "sum")
        if self.can_replay and not self.fixed and int(most) > r - max(2, r // 4):
            self.r = max(2 * int(most), r + 1)
        return {
            "max_episodes_per_chunk": most,
            "resets_per_chunk": torch.tensor(r, dtype=torch.int32, device=done.device),
            "replayed": replayed.int(),
        }


class Trajectory(NamedTuple):
    obs: torch.Tensor  # int32 [T, N, v*v] packed view
    direction: torch.Tensor  # int32 [T, N]
    action: torch.Tensor  # int32 [T, N]
    logp: torch.Tensor  # f32 [T, N], behaviour-policy log prob
    value: torch.Tensor  # f32 [T, N]
    reward: torch.Tensor  # f32 [T, N]
    done: torch.Tensor  # bool [T, N]


@torch.no_grad()
def collect_trajectory(
    env,
    model,
    env_states,
    generator: torch.Generator | None,
    rollout_steps: int,
    resets_per_chunk: int | None = None,
    fused_actor: bool = False,
    mesh=None,
    plain_obs: bool = False,
):
    """``rollout_steps`` policy steps of ``model`` (an ``rl/model.ActorCritic``)
    in every env; returns (env_states, Trajectory).

    ``fused_actor=True`` on CUDA tensors takes the whole-collection CUDA
    kernel (ops/actor_rollout.py): the env state, the reset cache (or, for
    a counter-reset family such as Dynamic-Obstacles, the per-env reset
    seeds) and the actor weights stay on the card for all steps and only
    the trajectory is written.  A configuration the kernel does not take
    raises there (``supports_fused_actor`` says which it takes).  On CPU tensors, or with
    ``fused_actor=False``, every step is the plain loop: the packed
    observation (through the observation kernel on the card, or with
    ``plain_obs``, the learners' ``_plain`` timing reference, its plain
    version), ``model``'s forward, Gumbel-argmax sampling from bits
    drawn from ``generator``, and the batched step with auto-reset.  The
    auto-reset of an ``expensive_reset`` family whose kernel reads a reset
    cache (DoorKey, FourRooms, GoToObject, GoToDoor, Fetch) draws from a
    per-env covering cache of ``resets_per_chunk`` levels, drawn from
    ``generator`` before the first step, through
    ``parallel/vector.make_cached_stepper``, as the JAX package's plain
    collector does (``minigrid_tpu/rl/rollout.py:140-182``); every other
    family regenerates ended episodes at every step.  Both routes sample
    with ``ops/actor_rollout.sample_actions``; the kernel's actor rounds as
    the TPU kernel does, the plain loop as ``model`` does.

    With a ``mesh`` (``parallel/mesh.Mesh``), ``env_states`` are this rank's
    shard and ``generator`` the rank's (``mesh.rank_generator``; the
    learners keep it in their ``TrainState``): the rank collects its shard
    by the same routes, and the trajectory stays on the rank.
    """
    if mesh is not None and env_states.device != mesh.device:
        raise ValueError(f"this rank's envs are on {env_states.device}, its mesh on {mesh.device}")
    num_envs = env_states.step_count.shape[0]
    if resets_per_chunk is None:
        resets_per_chunk = learner_resets(env, rollout_steps)
    if fused_actor and env_states.device.type == "cuda":
        env_states, traj = fused_actor_rollout(
            env, model, env_states, generator, rollout_steps, resets_per_chunk
        )
        return env_states, Trajectory(**traj)

    cached = env.expensive_reset and not counter_reset(env)
    if cached:
        cache = env.batch_reset_cache(num_envs, resets_per_chunk, generator, env_states.device)
        step_cached = make_cached_stepper(env, cache, num_envs)
        used = torch.zeros(num_envs, dtype=torch.int32, device=env_states.device)
    steps = []
    for _ in range(rollout_steps):
        obs = env.observation_packed(env_states, plain=plain_obs)
        direction = env_states.agent_dir
        logits, value = model(obs, direction, packed=True)
        bits = draw_bits(generator, (logits.shape[-1], num_envs), env_states.device)
        action, logp = sample_actions(logits, bits)
        if cached:
            env_states, reward, terminated, truncated, used = step_cached(env_states, action, used)
            done = terminated | truncated
        else:
            stepped, reward = env.step_env(env_states, action)
            done = stepped.terminated | stepped.truncated
            env_states = env.autoreset(stepped, generator)
        steps.append((obs, direction, action, logp, value, reward, done))
    return env_states, Trajectory(*(torch.stack(x) for x in zip(*steps)))
