"""The least time the H100 could take for the port's kernels' work.

One accounting for every bound the port states: ``chip_smoke.py``'s
``bound_ms`` column and the profiler's ``ppo-breakdown`` shares
(``tools/profiler.py``) both come from these functions.  A bound is the
larger of two times: the bytes the function must move (each input read
once, each output written once) over the card's memory rate, and the
operations it does over the card's peak rate for their type.  Where the
work depends on the data (episodes that end, levels read), the caller
passes what its run needed.

Arithmetic on shapes and counts: nothing here touches a device.
"""

from __future__ import annotations

from minigrid_tpu_torch.ops.fused_rollout import counter_reset

# The H100's peaks (NVIDIA's data sheet, SXM, dense): device memory, the
# CUDA cores' 32-bit rate (taken for integer ALU work too) and bf16 on the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12
# Integer operations of one threefry2x32-20 evaluation: 20 rounds of add,
# rotate and xor, 5 key injections of 3 adds, 2 initial adds, 2 xors.
THREEFRY_OPS = 79


def bound(nbytes: float, op_seconds: float) -> tuple[float, str]:
    """The least time in ms the card could take for work that moves
    ``nbytes`` and whose operations take ``op_seconds`` at the card's peak
    rates for their types, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_bytes, op_seconds) * 1e3, "bytes" if t_bytes >= op_seconds else "operations"


def rollout_bytes(env, states, steps: int, resets: float = 0, seeds: bool = False) -> int:
    """Bytes a whole-rollout call must move: the actions, the state read and
    written, the ``resets`` reset-cache levels per env it reads or the
    seeds, and the four per-env outputs written.  A state or level is what
    the family's instantiation touches: the grid, the 8 scalar rows and the
    ext's extra scalars and byte planes, the contents plane unless
    ``fused_no_objects``, the mission (BabyAI's 44 wide) unless
    ``fused_static_mission``."""
    n, w, h = states.grid.shape
    planes = 1 + (not env.fused_no_objects)
    mission = 0 if env.fused_static_mission else states.mission.shape[-1]
    scalars = env.fused_ext.n_scalars if env.fused_ext is not None else 0
    ext_planes = env.fused_ext.n_planes if env.fused_ext is not None else 0
    # int32 words, and the ext's planes of one byte per cell.
    state = n * (planes * w * h + 8 + mission + scalars) * 4 + n * ext_planes * w * h
    return int(4 * steps * n + 2 * state + resets * state + 8 * n * seeds + 16 * n)


def rollout_bound(env, states, steps: int, resets: float = 0, compute_obs: bool = False) -> tuple[float, str]:
    """The random-policy kernel's bound for ``steps`` steps of ``states``
    reading ``resets`` levels per env (``rollout_bytes``); with
    observations, each step also adds its view's v*v cells into the
    checksum, an integer add per cell on the CUDA cores, which a view of
    31 makes the larger of the two at 65536 envs."""
    n = states.step_count.shape[0]
    v2 = env.agent_view_size**2
    ops = steps * n * v2 if compute_obs else 0
    return bound(rollout_bytes(env, states, steps, resets), ops / CUDA_CORE_OPS_PER_S)


def levels_read(episodes: int, n: int, r: int) -> float:
    """Reset-cache levels per env a rollout reads: one per ended episode,
    at most R per env (past R the last slot is read again)."""
    return min(episodes, n * r) / n


def threefry_evaluations(env, env_steps: int, resets: int) -> int:
    """The threefry evaluations a counter-reset rollout needs: per reset the
    episode seed and the placement pairs (and Dynamic-Obstacles' walk
    seed; a family written outside the package declares its count as
    ``reset_threefry``), per env-step one per two walking balls."""
    if hasattr(env, "n_obstacles"):
        words = env.n_obstacles + (2 if env.agent_start_pos is None else 0)
        return resets * (2 + (words + 1) // 2) + env_steps * ((env.n_obstacles + 1) // 2)
    if hasattr(env, "num_crossings"):
        return resets * (1 + (3 * env.num_crossings + 1) // 2)
    return resets * getattr(env, "reset_threefry", 2)


def dense_ops(hidden: int, num_actions: int) -> int:
    """Multiply-add operations (2 each) of one sample's layer 2 and heads,
    the bf16 products after the first layer."""
    return 2 * hidden * (hidden + num_actions + 1)


def actor_bound(env, states0, weights, num_steps: int, episodes: int, resets: int = 0) -> tuple[float, str]:
    """The actor kernel's bound for ``num_steps`` steps of the envs of
    ``states0`` (``ops/actor_rollout``, K2): the sampling bits, the state
    (extra scalars included) and the cache levels its ``episodes`` read
    from a cache of ``resets`` levels an env, or the seeds, the state and
    the trajectory written, the ``weights`` (an ``ActorWeights``) read once;
    layer 1 adds the 3 v*v + 1 selected rows in f32 on the CUDA cores,
    layer 2 and the heads are bf16 products at the tensor cores' rate, and
    a counter-reset family's threefry evaluations (this run's resets and
    walk) are integer work on the CUDA cores."""
    n = states0.step_count.shape[0]
    n_pos = num_steps * n
    v2 = env.agent_view_size**2
    hidden = weights.b1.numel()
    counter = counter_reset(env)
    levels = 0 if counter else levels_read(episodes, n, resets)
    moved = (
        n_pos * env.num_actions * 4
        + rollout_bytes(env, states0, 0, levels, seeds=counter)
        + sum(w.numel() * w.element_size() for w in weights)
        + n_pos * (v2 * 4 + 5 * 4 + 1)
    )
    op_seconds = n_pos * (
        (3 * v2 + 1) * hidden / CUDA_CORE_OPS_PER_S + dense_ops(hidden, env.num_actions) / BF16_TENSOR_OPS_PER_S
    )
    if counter:
        op_seconds += THREEFRY_OPS * threefry_evaluations(env, n_pos, episodes) / CUDA_CORE_OPS_PER_S
    return bound(moved, op_seconds)


def embed_bound(m: int, v2: int, hidden: int, direction: str) -> tuple[float, str]:
    """The embed + dense-1 kernels' bound at ``m`` samples of a v*v = ``v2``
    view (``ops/embed_dense``, K3): each sample adds its 3 v2 + 1 selected
    rows of W1 (forward) or adds dy into them (``direction="bwd"``), in f32
    on the CUDA cores.  The forward reads the packed views, the directions,
    W1 and b1 once and writes the bf16 output; the backward reads the views,
    the directions and the bf16 dy once and writes dW1 and db1."""
    weights = (v2 * 20 + 4) * hidden + hidden
    if direction == "fwd":
        moved = (m * (v2 + 1) + weights) * 4 + m * hidden * 2
    elif direction == "bwd":
        moved = m * (v2 + 1) * 4 + m * hidden * 2 + weights * 4
    else:
        raise ValueError(f"direction {direction!r} is neither 'fwd' nor 'bwd'")
    return bound(moved, m * (3 * v2 + 1) * hidden / CUDA_CORE_OPS_PER_S)


def ppo_update_bound(env, num_envs: int, num_steps: int, hidden: int, num_minibatches: int) -> float:
    """The least time in ms of a PPO update (``rl/ppo``) on a trajectory of
    ``num_envs`` x ``num_steps``: its embed + dense-1 launches at their
    bounds, one for the bootstrap value at ``num_envs`` samples and a
    forward and a backward a minibatch, in turn, plus the bf16 products of
    layer 2 and the heads at the tensor cores' rate: forward on every
    sample and the bootstrap, backward (two products a forward one) on
    every sample."""
    v2 = env.agent_view_size**2
    mb = num_steps // num_minibatches * num_envs
    k3 = embed_bound(num_envs, v2, hidden, "fwd")[0] + num_minibatches * (
        embed_bound(mb, v2, hidden, "fwd")[0] + embed_bound(mb, v2, hidden, "bwd")[0]
    )
    samples = (3 * num_steps + 1) * num_envs
    return k3 + samples * dense_ops(hidden, env.num_actions) / BF16_TENSOR_OPS_PER_S * 1e3
