"""Whole-rollout fused kernel: T random-policy steps with the state on the card.

Port of ``minigrid_tpu/ops/fused_rollout.py`` for families without a fused
ext.  The kernel (``csrc/fused_rollout.cu``, CUDA C++ for Hopper) replaces
the Pallas kernel ``_rollout_kernel``: per env it runs the core transition,
the auto-reset from an R-slot reset cache and, with ``compute_obs``, a
checksum of every packed observation (the sum of the visible view cells,
wrapping at int32), so that observations are consumed without being
written out.

``fused_rollout_core`` dispatches on the device of the state: CUDA tensors
launch the kernel (or raise), CPU tensors run ``fused_rollout_reference``,
the plain PyTorch version of the same semantics.  ``KERNEL_LAUNCHES`` counts
the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from minigrid_tpu_torch.core.env import MiniGridEnv, cache_slot
from minigrid_tpu_torch.core.obs import view_and_vis
from minigrid_tpu_torch.core.state import EnvState, select
from minigrid_tpu_torch.ops._build import load_library

# View sizes the CUDA source instantiates (every registered ext-free family
# uses 7).
COMPILED_VIEW_SIZES = (7,)
# Launches of the CUDA kernel since import (or since a caller reset it).
KERNEL_LAUNCHES = 0

_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 11 + [ctypes.c_void_p]


def supports_fused(env) -> bool:
    """True if the family's transition is the default-hook core step and its
    observation the default one: what the kernel computes."""
    cls = type(env)
    return (
        cls._pre_step is MiniGridEnv._pre_step
        and cls._post_step is MiniGridEnv._post_step
        and cls._map_action is MiniGridEnv._map_action
        and cls.observation is MiniGridEnv.observation
    )


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """An int64 sum reduced to int32 with two's-complement wraparound, as
    JAX's int32 sums wrap."""
    return ((x.long() + 2**31) % 2**32 - 2**31).to(torch.int32)


def fused_rollout(
    env,
    states: EnvState,
    generator: torch.Generator | None,
    num_steps: int,
    resets_per_chunk: int = 2,
    compute_obs: bool = True,
):
    """Run ``num_steps`` uniform-random steps of every env.

    Draws the action stream [T, N] and then an R-slot reset cache from
    ``generator`` (on the states' device).  Returns ``(final_states,
    total_reward, episodes_finished, obs_checksum, max_used)``; ``max_used``
    is the most cache slots any env consumed, which callers hold to R
    (parallel/reset_budget).
    """
    n, device = states.step_count.shape[0], states.device
    actions = torch.randint(
        0, env.num_actions, (num_steps, n), generator=generator, device=device, dtype=torch.int32
    )
    cache = env.batch_reset_cache(n, resets_per_chunk, generator, device)
    return fused_rollout_core(env, states, cache, actions, compute_obs)


def fused_rollout_core(env, states: EnvState, cache: EnvState, actions: torch.Tensor, compute_obs: bool = True):
    """The rollout over explicit ``actions`` int32[T, N] and reset ``cache``
    (leaves [N, R, ...]): the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if states.device.type == "cpu":
        return fused_rollout_reference(env, states, cache, actions, compute_obs)
    return _launch(env, states, cache, actions, compute_obs)


def fused_rollout_reference(env, states: EnvState, cache: EnvState, actions: torch.Tensor, compute_obs: bool = True):
    """Plain PyTorch version of the kernel, on any device: a loop over T of
    the batched step, the cache blend and the observation checksum."""
    n = states.step_count.shape[0]
    device = states.device
    used = torch.zeros(n, dtype=torch.int32, device=device)
    done_count = torch.zeros(n, dtype=torch.int32, device=device)
    rew_sum = torch.zeros(n, dtype=torch.float32, device=device)
    checksum = torch.zeros(n, dtype=torch.int64, device=device)
    st = states
    for action in actions:
        stepped, reward = env.step_env(st, action)
        done = stepped.terminated | stepped.truncated
        rew_sum = rew_sum + reward
        done_count = done_count + done.int()
        st = select(done, cache_slot(cache, used), stepped)
        used = used + done.int()
        if compute_obs:
            cells, vis = view_and_vis(st, env.agent_view_size, env.see_through_walls)
            checksum = checksum + torch.where(vis, cells, 0).sum(dim=(1, 2), dtype=torch.int64)
    return (
        st,
        rew_sum.sum(),
        wrap_int32(done_count.sum(dtype=torch.int64)),
        wrap_int32(checksum.sum()),
        used.max(),
    )


def _require(cond: bool, message: str, what: str = "fused_rollout") -> None:
    if not cond:
        raise ValueError(f"{what} kernel: {message}")


def check_env_and_state(env, states: EnvState, cache: EnvState, what: str) -> int:
    """Raise unless a whole-rollout kernel takes this env, state and reset
    cache (CUDA, default hooks, no ext, a compiled view size, int32 leaves of
    the right shapes on one device); returns R."""
    device = states.device
    _require(device.type == "cuda", f"state on {device}, need CUDA (or CPU for the plain version)", what)
    _require(supports_fused(env), f"{type(env).__name__} has step hooks the kernel does not run", what)
    _require(getattr(env, "fused_ext", None) is None, "fused exts are not ported yet", what)
    v = env.agent_view_size
    _require(v in COMPILED_VIEW_SIZES, f"view size {v} has no compiled instantiation", what)
    n = states.step_count.shape[0]
    w, h = env.width, env.height
    r = cache.step_count.shape[1] if cache.step_count.dim() == 2 else 0
    m = states.mission.shape[-1]
    _require(r >= 1 and cache.step_count.shape[0] == n, "cache leaves must be [N, R >= 1, ...]", what)
    for name, x, shape in (
        ("grid", states.grid, (n, w, h)),
        ("contains", states.contains, (n, w, h)),
        ("mission", states.mission, (n, m)),
        ("cache grid", cache.grid, (n, r, w, h)),
        ("cache contains", cache.contains, (n, r, w, h)),
        ("cache mission", cache.mission, (n, r, m)),
    ):
        _require(tuple(x.shape) == shape, f"{name} must be {shape}, got {tuple(x.shape)}", what)
    every = [getattr(states, f) for f in ("grid", "contains", "mission")] + [
        getattr(cache, f) for f in ("grid", "contains", "mission")
    ]
    _require(all(x.dtype == torch.int32 for x in every), "state tensors must be int32", what)
    _require(all(x.device == device for x in every), "tensors on different devices", what)
    return r


def _rows(s: EnvState) -> torch.Tensor:
    """The 8 scalar rows of the kernels, stacked on a new leading axis."""
    return torch.stack(
        [
            x.to(torch.int32)
            for x in (
                s.agent_x, s.agent_y, s.agent_dir, s.carrying, s.step_count, s.max_steps,
                s.terminated, s.truncated,
            )
        ]
    )


def to_env_minor(states: EnvState, cache: EnvState) -> tuple[torch.Tensor, ...]:
    """The kernels' env-minor buffers (thread n reads column n): state grid
    and contents [W*H, N], scalar rows [8, N], mission [M, N], and the cache
    as [R, W*H, N], [R, W*H, N], [R, 8, N], [R, M, N].  The state buffers
    are fresh copies the kernel updates in place."""
    n, r = cache.step_count.shape
    wh = states.grid.shape[1] * states.grid.shape[2]
    return (
        states.grid.reshape(n, wh).t().contiguous(),
        states.contains.reshape(n, wh).t().contiguous(),
        _rows(states).contiguous(),
        states.mission.t().contiguous(),
        cache.grid.reshape(n, r, wh).permute(1, 2, 0).contiguous(),
        cache.contains.reshape(n, r, wh).permute(1, 2, 0).contiguous(),
        _rows(cache).permute(2, 0, 1).contiguous(),
        cache.mission.permute(1, 2, 0).contiguous(),
    )


def from_env_minor(states: EnvState, grid, cont, sc, mis) -> EnvState:
    """``states`` with the kernel's final env-minor buffers put back."""
    n, w, h = states.grid.shape
    return states.replace(
        grid=grid.t().reshape(n, w, h).contiguous(),
        contains=cont.t().reshape(n, w, h).contiguous(),
        agent_x=sc[0],
        agent_y=sc[1],
        agent_dir=sc[2],
        carrying=sc[3],
        step_count=sc[4],
        max_steps=sc[5],
        terminated=sc[6] != 0,
        truncated=sc[7] != 0,
        mission=mis.t().contiguous(),
    )


def _launch(env, states: EnvState, cache: EnvState, actions: torch.Tensor, compute_obs: bool):
    global KERNEL_LAUNCHES
    r = check_env_and_state(env, states, cache, "fused_rollout")
    device = states.device
    n = states.step_count.shape[0]
    t = actions.shape[0]
    _require(actions.shape == (t, n), f"actions must be [T, {n}], got {tuple(actions.shape)}")
    _require(actions.dtype == torch.int32 and actions.device == device, "actions must be int32 on the state's device")

    grid, cont, sc, mis, cgrid, ccont, csc, cmis = to_env_minor(states, cache)
    acts = actions.contiguous()
    used = torch.zeros(n, dtype=torch.int32, device=device)
    obs = torch.zeros_like(used)
    rew = torch.zeros(n, dtype=torch.float32, device=device)
    done = torch.zeros_like(used)

    lib = load_library("fused_rollout")
    fn = lib.fused_rollout_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            *(x.data_ptr() for x in (acts, grid, cont, sc, mis, cgrid, ccont, csc, cmis, used, obs, rew, done)),
            env.width, env.height, env.agent_view_size, r, states.mission.shape[-1], t, n,
            int(bool(getattr(env, "fused_no_objects", False))),
            int(bool(getattr(env, "fused_static_mission", False))),
            int(env.see_through_walls),
            int(bool(compute_obs)),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_rollout kernel launch failed with CUDA error {err}")
    KERNEL_LAUNCHES += 1

    return (
        from_env_minor(states, grid, cont, sc, mis),
        rew.sum(),
        wrap_int32(done.sum(dtype=torch.int64)),
        wrap_int32(obs.sum(dtype=torch.int64)),
        used.max(),
    )
