"""Whole-rollout fused kernel: T random-policy steps with the state on the card.

Port of ``minigrid_tpu/ops/fused_rollout.py``.  The kernel
(``csrc/fused_rollout.cu``, CUDA C++ for Hopper) replaces the Pallas kernel
``_rollout_kernel``: per env it runs the family's hooks around the core
transition, the auto-reset and, with ``compute_obs``, a checksum of every
packed observation (the sum of the visible view cells, wrapping at int32),
so that observations are consumed without being written out.  Families
without a fused ext (fixed-start Empty, DoorKey, FourRooms) reset from an
R-slot reset cache, and so do the cached exts (``fused_ext.CachedExt``:
GoToObject, GoToDoor, Fetch, the RoomGrid families, Memory, PutNear,
RedBlueDoors, and BabyAI's verifier with its two planes), whose extra
scalars and planes the kernel blends from the same cache slot;
a ``covers_reset`` ext with a compiled twin (``FusedExt.kernel_id``:
random-start Empty, Crossing, Dynamic-Obstacles, or a family's own header)
regenerates a fresh level in the kernel from per-env seeds, with no cache.

``fused_rollout_core`` dispatches on the device of the state: CUDA tensors
launch the kernel (or raise), CPU tensors run ``fused_rollout_reference``,
the plain PyTorch version of the same semantics.  ``KERNEL_LAUNCHES`` counts
the kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from minigrid_tpu_torch.core.env import MiniGridEnv, cache_slot
from minigrid_tpu_torch.core.obs import view_and_vis
from minigrid_tpu_torch.core.state import EnvState, select
from minigrid_tpu_torch.ops._build import Shape, load_library
from minigrid_tpu_torch.ops.fused_ext import EXT_USER, USER_SLOTS, user_slots
from minigrid_tpu_torch.ops.prng import draw_seeds

# The view size of the built-in libraries (every registered family's) and
# the actor kernel's widths there (PPO's 256 and the tests' 64); the kernels
# take every odd view from 3 to MAX_VIEW, any other shape built at its first
# launch for the family that launches it (``kernel_library``).
BUILTIN_VIEW = 7
BUILTIN_HIDDEN = (64, 256)
MAX_VIEW = 31
# Launches of the CUDA kernel since import (or since a caller reset it).
KERNEL_LAUNCHES = 0

_ARGTYPES = [ctypes.c_void_p] * 25 + [ctypes.c_int] * 25 + [ctypes.c_void_p]


def supports_fused(env) -> bool:
    """True if the kernel can run the family's transition: the default-hook
    core step, or a fused ext (``ops/fused_ext.py``) that twins its hooks,
    ``_pre_step`` included where it overrides that; the observation must be
    the default one (``minigrid_tpu/ops/fused_rollout.py:536-555``)."""
    cls = type(env)
    if cls.observation is not MiniGridEnv.observation:
        return False
    ext = env.fused_ext
    if ext is not None:
        return ext.covers_pre_step or cls._pre_step is MiniGridEnv._pre_step
    return (
        cls._pre_step is MiniGridEnv._pre_step
        and cls._post_step is MiniGridEnv._post_step
        and cls._map_action is MiniGridEnv._map_action
    )


def counter_reset(env) -> bool:
    """Whether the family regenerates levels from the counter stream
    (``FusedExt.covers_reset``) instead of a reset cache."""
    return env.fused_ext is not None and env.fused_ext.covers_reset


def compiled_ext(env) -> bool:
    """Whether the CUDA kernel has the family's ext: none needed, or a
    compiled twin (``kernel_id``; ``EXT_USER`` with the family's own header,
    ``kernel_source``, built at first launch) whose sizes fit its slots
    (``kernel_params``) and whose ``kernel_switches`` the family's flags
    meet."""
    ext = env.fused_ext
    if ext is None:
        return True
    if ext.kernel_id is None or ext.kernel_params(env) is None:
        return False
    if (ext.kernel_id == EXT_USER) != (ext.kernel_source is not None):
        return False
    flags = (env.fused_no_objects, env.fused_static_mission, env.see_through_walls)
    return all(s is None or s == bool(f) for s, f in zip(ext.kernel_switches, flags))


def view_refusal(view_size: int) -> str | None:
    """Why the rollout kernels do not take this view size, or None: they
    take every odd view from 3 to ``MAX_VIEW``, whose rows' masks fit the
    flood's 32-bit words."""
    if view_size % 2 != 1 or not 3 <= view_size <= MAX_VIEW:
        return f"view size {view_size}; the kernels take odd views from 3 to {MAX_VIEW}"
    return None


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

    Draws the action stream [T, N] from ``generator`` (on the states'
    device), then either the per-env counter-reset seeds int32 [N, 2]
    (``covers_reset`` families) or an R-slot reset cache.  Returns
    ``(final_states, total_reward, episodes_finished, obs_checksum,
    max_used)``; ``max_used`` is the most cache slots any env consumed,
    which callers hold to R (parallel/reset_budget), and 0 on the counter
    path, which has no cache to run out.
    """
    n, device = states.step_count.shape[0], states.device
    actions = torch.randint(
        0, env.num_actions, (num_steps, n), generator=generator, device=device, dtype=torch.int32
    )
    if counter_reset(env):
        return fused_rollout_core(env, states, None, actions, compute_obs, draw_seeds(generator, n, device))
    cache = env.batch_reset_cache(n, resets_per_chunk, generator, device)
    return fused_rollout_core(env, states, cache, actions, compute_obs)


def fused_rollout_core(
    env,
    states: EnvState,
    cache: EnvState | None,
    actions: torch.Tensor,
    compute_obs: bool = True,
    reset_seeds: torch.Tensor | None = None,
):
    """The rollout over explicit ``actions`` int32[T, N] and reset ``cache``
    (leaves [N, R, ...]), or, for ``covers_reset`` families, ``cache=None``
    and ``reset_seeds`` int32 [N, 2]: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if states.device.type == "cpu":
        return fused_rollout_reference(env, states, cache, actions, compute_obs, reset_seeds)
    return _launch(env, states, cache, actions, compute_obs, reset_seeds)


def fused_rollout_reference(
    env,
    states: EnvState,
    cache: EnvState | None,
    actions: torch.Tensor,
    compute_obs: bool = True,
    reset_seeds: torch.Tensor | None = None,
):
    """Plain PyTorch version of the kernel, on any device: a loop over T of
    the batched step (family hooks included), the auto-reset and the
    observation checksum.  The auto-reset blends cache slot min(used, R-1),
    or the ext's ``reset_block`` at episode ordinal ``used``, both taken
    with the pre-increment ``used``."""
    check_ext(env, states, cache, "fused_rollout")
    counter = counter_reset(env)
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
        st = select(done, fresh_episodes(env, cache, reset_seeds, used), stepped)
        used = used + done.int()
        if compute_obs:
            cells, vis = view_and_vis(st, env.agent_view_size, env.see_through_walls)
            checksum = checksum + torch.where(vis, cells, 0).sum(dim=(1, 2), dtype=torch.int64)
    return (
        st,
        rew_sum.sum(),
        wrap_int32(done_count.sum(dtype=torch.int64)),
        wrap_int32(checksum.sum()),
        torch.zeros((), dtype=torch.int32, device=device) if counter else used.max(),
    )


def fresh_episodes(env, cache: EnvState | None, reset_seeds: torch.Tensor | None, used: torch.Tensor) -> EnvState:
    """The episodes an auto-reset at per-env ordinals ``used`` (the
    pre-increment reset counts) draws: the ext's ``reset_block`` on
    ``reset_seeds`` for a counter-reset family, else reset-cache slot
    min(used, R-1)."""
    if not counter_reset(env):
        return cache_slot(cache, used)
    if reset_seeds is None:
        raise ValueError(f"{type(env).__name__} regenerates levels from reset_seeds; pass them")
    return env.fused_ext.reset_block(env, reset_seeds, used)


def kernel_shape(name: str, env, hidden: int | None = None) -> Shape | None:
    """The ``_build.Shape`` that rollout kernel ``name`` runs ``env`` at
    (``hidden`` the actor's width; None, one the built-in library holds),
    or None where the built-in library holds it: view ``BUILTIN_VIEW`` and,
    for the actor kernel, a width of ``BUILTIN_HIDDEN``.  The shape's
    library holds the family's ext alone, at the family's switches
    (``kernel_flags``)."""
    v = env.agent_view_size
    if v == BUILTIN_VIEW and (name == "fused_rollout" or hidden is None or hidden in BUILTIN_HIDDEN):
        return None
    if name != "fused_rollout" and hidden is None:
        raise ValueError(f"{name} at view {v}: name the hidden width of its library")
    ext = env.fused_ext
    user = ext is not None and ext.kernel_source is not None
    ext_id = None if user else (0 if ext is None else ext.kernel_id)
    return Shape(v, 0 if name == "fused_rollout" else int(hidden), ext_id, kernel_flags(env))


def kernel_flags(env) -> tuple[int, int, int]:
    """The rollout kernels' switches NO_OBJECTS, STATIC_MISSION and
    SEE_THROUGH for ``env``, as its launches pass them."""
    return int(bool(env.fused_no_objects)), int(bool(env.fused_static_mission)), int(env.see_through_walls)


def kernel_library(name: str, env, hidden: int | None = None):
    """The library of rollout kernel ``name`` (``fused_rollout`` or
    ``actor_rollout``) for ``env`` (at the actor's ``hidden`` width): the
    built-in one, the one built with the family's own ext header
    (``FusedExt.kernel_source``), or, at another view or width
    (``kernel_shape``), the one built for that shape and the family's ext.
    A user struct must declare what the Python twin does (``ValueError``
    otherwise): its ``MAX_K``, ``NUM_PLANES``, ``SWITCHES``,
    ``COUNTER_RESET`` and ``PRE_STEP`` are the twin's ``n_scalars``,
    ``n_planes``, ``kernel_switches``, ``covers_reset`` and
    ``covers_pre_step``."""
    ext = env.fused_ext
    shape = kernel_shape(name, env, hidden)
    at_shape = {} if shape is None else {"shape": shape}
    if ext is None or ext.kernel_source is None:
        return load_library(name, **at_shape)
    lib = load_library(name, ext.kernel_source, ext.kernel_struct, **at_shape)
    layout = (ctypes.c_int * 7)()
    _require(lib.minigrid_ext_layout(EXT_USER, layout) == 1, "the user library holds no EXT_USER", name)
    switch = {1: True, 0: False, -1: None}
    declared = (layout[0], layout[1], tuple(switch[v] for v in layout[2:5]), bool(layout[5]), bool(layout[6]))
    twin = (ext.n_scalars, ext.n_planes, tuple(ext.kernel_switches), bool(ext.covers_reset), bool(ext.covers_pre_step))
    _require(
        declared == twin,
        f"{ext.kernel_struct} in {ext.kernel_source} declares MAX_K, NUM_PLANES, SWITCHES, COUNTER_RESET, PRE_STEP "
        f"{declared}, its Python twin n_scalars, n_planes, kernel_switches, covers_reset, covers_pre_step {twin}",
        name,
    )
    return lib


def _require(cond: bool, message: str, what: str = "fused_rollout") -> None:
    if not cond:
        raise ValueError(f"{what} kernel: {message}")


def check_ext(env, states: EnvState, cache: EnvState | None, what: str) -> None:
    """Raise for an ext the kernels cannot run, and the plain versions with
    them: one with extra planes but no compiled twin, whose planes no
    kernel would carry, and a cached ext whose state or reset cache lacks
    its extra scalars or planes."""
    ext, name = env.fused_ext, type(env).__name__
    if ext is None:
        return
    _require(
        ext.n_planes == 0 or ext.kernel_id is not None,
        f"{name}'s fused ext carries {ext.n_planes} extra planes per env (P planes) and has no "
        "compiled twin to carry them",
        what,
    )
    if not ext.covers_reset and (ext.n_scalars or ext.n_planes):
        _require(
            cache is not None and cache.extra is not None and states.extra is not None,
            f"{name}'s fused ext blends {ext.n_scalars} extra scalars and {ext.n_planes} planes from the "
            "reset cache; the state and the cache must both carry them",
            what,
        )


def check_env_and_state(env, states: EnvState, cache: EnvState | None, what: str) -> int:
    """Raise unless a whole-rollout kernel takes this env, state and reset
    cache (CUDA, hooks it runs, a compiled fused ext where the family has
    one, a view it takes, int32 leaves of the right shapes on one device);
    returns R, which is 0 for a counter-reset family (``cache`` None)."""
    device = states.device
    name = type(env).__name__
    _require(device.type == "cuda", f"state on {device}, need CUDA (or CPU for the plain version)", what)
    check_ext(env, states, cache, what)
    _require(supports_fused(env), f"{name} has step hooks the kernel does not run", what)
    _require(compiled_ext(env), f"{name}'s fused ext has no compiled CUDA twin", what)
    refusal = view_refusal(env.agent_view_size)
    _require(refusal is None, refusal, what)
    n = states.step_count.shape[0]
    w, h = env.width, env.height
    m = states.mission.shape[-1]
    shapes = [("grid", states.grid, (n, w, h)), ("contains", states.contains, (n, w, h)), ("mission", states.mission, (n, m))]
    if counter_reset(env):
        _require(cache is None, "a counter-reset family takes reset seeds, not a cache", what)
        r = 0
    else:
        r = cache.step_count.shape[1] if cache.step_count.dim() == 2 else 0
        _require(r >= 1 and cache.step_count.shape[0] == n, "cache leaves must be [N, R >= 1, ...]", what)
        shapes += [
            ("cache grid", cache.grid, (n, r, w, h)),
            ("cache contains", cache.contains, (n, r, w, h)),
            ("cache mission", cache.mission, (n, r, m)),
        ]
    for label, x, shape in shapes:
        _require(tuple(x.shape) == shape, f"{label} must be {shape}, got {tuple(x.shape)}", what)
    _require(all(x.dtype == torch.int32 for _, x, _ in shapes), "state tensors must be int32", what)
    _require(all(x.device == device for _, x, _ in shapes), "tensors on different devices", what)
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


def to_env_minor(states: EnvState, cache: EnvState | None) -> tuple:
    """The actor kernel's env-minor buffers (thread n reads column n): state grid
    and contents [W*H, N], scalar rows [8, N], mission [M, N], and the cache
    as [R, W*H, N], [R, W*H, N], [R, 8, N], [R, M, N] (four Nones without a
    cache).  The state buffers are fresh copies the kernel updates in
    place."""
    n = states.step_count.shape[0]
    wh = states.grid.shape[1] * states.grid.shape[2]
    live = (
        states.grid.reshape(n, wh).t().contiguous(),
        states.contains.reshape(n, wh).t().contiguous(),
        _rows(states).contiguous(),
        states.mission.t().contiguous(),
    )
    if cache is None:
        return live + (None,) * 4
    r = cache.step_count.shape[1]
    return live + (
        cache.grid.reshape(n, r, wh).permute(1, 2, 0).contiguous(),
        cache.contains.reshape(n, r, wh).permute(1, 2, 0).contiguous(),
        _rows(cache).permute(2, 0, 1).contiguous(),
        cache.mission.permute(1, 2, 0).contiguous(),
    )


def from_env_minor(states: EnvState, grid, cont, sc, mis) -> EnvState:
    """``states`` with the actor kernel's final env-minor buffers put back."""
    n, w, h = states.grid.shape
    return _with_rows(states, grid.t().reshape(n, w, h).contiguous(), cont.t().reshape(n, w, h).contiguous(), sc,
                      mis.t().contiguous())


def _with_rows(states: EnvState, grid, contains, sc, mission) -> EnvState:
    """``states`` with a kernel's final grid, contents, mission and 8 scalar
    rows [8, N]."""
    return states.replace(
        grid=grid,
        contains=contains,
        agent_x=sc[0],
        agent_y=sc[1],
        agent_dir=sc[2],
        carrying=sc[3],
        step_count=sc[4],
        max_steps=sc[5],
        terminated=sc[6] != 0,
        truncated=sc[7] != 0,
        mission=mission,
    )


class KernelBuffers(NamedTuple):
    """What the rollout kernel reads and writes, in its layouts: the state's
    grid and contents [N, W*H] and mission [N, M] (the state's own, cloned
    where the kernel writes them), its 8 scalar rows [8, N], and the reset
    cache as ``batch_reset_cache`` returns it, grid and contents [N, R, W*H],
    mission [N, R, M] and its 8 scalar fields [N, R] (six int32, the two
    flags bool) (Nones without a cache); ``ext``, the ext's buffers,
    env-major."""

    grid: torch.Tensor
    cont: torch.Tensor
    sc: torch.Tensor
    mis: torch.Tensor
    cgrid: torch.Tensor | None
    ccont: torch.Tensor | None
    csc: tuple[torch.Tensor, ...]
    cmis: torch.Tensor | None
    ext: "ExtBuffers"


def kernel_buffers(env, states: EnvState, cache: EnvState | None, reset_seeds, what: str = "fused_rollout"):
    """The rollout kernel's buffers (``KernelBuffers``): no permute of the
    state or the cache, whose leaves the kernel reads where they lie; the
    grid (and the contents and mission, where the family's instantiation
    writes them) cloned once for the kernel to update in place."""
    n, w, h = states.grid.shape

    def rows(x: torch.Tensor, width: int, writes: bool) -> torch.Tensor:
        x = x.reshape(n, width)
        return x.clone(memory_format=torch.contiguous_format) if writes else x.contiguous()

    live = (
        rows(states.grid, w * h, True),
        rows(states.contains, w * h, not env.fused_no_objects),
        _rows(states),
        rows(states.mission, states.mission.shape[-1], not env.fused_static_mission),
    )
    ext = ext_buffers(env, states, cache, reset_seeds, what, env_major=True)
    if cache is None:
        return KernelBuffers(*live, None, None, (None,) * 8, None, ext)
    r = cache.step_count.shape[1]
    fields = (cache.agent_x, cache.agent_y, cache.agent_dir, cache.carrying, cache.step_count, cache.max_steps)
    return KernelBuffers(
        *live,
        cache.grid.reshape(n, r, w * h).contiguous(),
        cache.contains.reshape(n, r, w * h).contiguous(),
        tuple(x.to(torch.int32).contiguous() for x in fields)
        + tuple(x.to(torch.bool).contiguous() for x in (cache.terminated, cache.truncated)),
        cache.mission.contiguous(),
        ext,
    )


def _pointer(x: torch.Tensor | None) -> int | None:
    return None if x is None else x.data_ptr()


class ExtBuffers(NamedTuple):
    """The ext arguments of a whole-rollout kernel (``ext_buffers``), in the
    actor kernel's env-minor layout or, ``env_major``, in the rollout
    kernel's, where the env is the leading axis of each."""

    scal: torch.Tensor | None  # int32 [K, N] extra scalars, updated in place ([N, K])
    cscal: torch.Tensor | None  # int32 [R, K, N] a cached ext's cache scalars ([N, R, K])
    planes: torch.Tensor | None  # uint8 [P, W*H, N] extra planes, updated in place ([N, P, W*H])
    cplanes: torch.Tensor | None  # uint8 [R, P, W*H, N] a cached ext's cache planes ([N, R, P, W*H])
    seeds: torch.Tensor | None  # int32 [2, N] a counter-reset ext's seeds ([N, 2])
    ext_id: int
    params: tuple[int, ...]  # ExtParams' named fields (FusedExt.kernel_params)
    user: tuple[int, ...]  # ExtParams::user (fused_ext.user_slots)
    env_major: bool = False

    def pointers(self) -> tuple:
        """The five buffers' addresses in the launch functions' order."""
        return tuple(None if x is None else x.data_ptr() for x in (self.cscal, self.scal, self.planes, self.cplanes, self.seeds))


def _plane_bytes(
    planes: torch.Tensor, lead: tuple[int, ...], p: int, cells: int, device, what: str, env_major: bool
) -> torch.Tensor:
    """int32 [*lead, P, W*H] planes as bytes (every value must fit in one),
    env-minor [*lead[1:], P, W*H, N] or, ``env_major``, as they are."""
    _require(
        planes is not None and tuple(planes.shape) == lead + (p, cells), f"extra planes must pack to {lead + (p, cells)}", what
    )
    _require(bool(((planes >= 0) & (planes < 256)).all()), "extra plane values must fit in a byte", what)
    if env_major:  # a copy: the kernel updates the live planes in place
        return planes.to(device=device, dtype=torch.uint8, memory_format=torch.contiguous_format, copy=True)
    order = tuple(range(1, len(lead))) + (len(lead), len(lead) + 1, 0)
    return planes.to(device=device, dtype=torch.uint8).permute(order).contiguous()


def ext_buffers(
    env, states: EnvState, cache: EnvState | None, reset_seeds: torch.Tensor | None, what: str, env_major: bool = False
) -> ExtBuffers:
    """The ext arguments of a whole-rollout kernel: the extra scalars and
    planes as copies the kernel updates in place, a cached ext's cache
    scalars and planes, a counter-reset ext's seeds (each None where the ext
    has none), the ext's kernel id and its ``ExtParams``; env-minor for the
    actor kernel, or ``env_major`` for the rollout kernel, which takes the
    packed ext state and seeds as they come."""
    ext = env.fused_ext
    if ext is None:
        return ExtBuffers(None, None, None, None, None, 0, (0,) * 7, (0,) * USER_SLOTS, env_major)
    n, device = states.step_count.shape[0], states.device
    cells = env.width * env.height
    ids = (ext.kernel_id, ext.kernel_params(env), user_slots(ext, env))

    def minor(x: torch.Tensor, order: tuple[int, ...]) -> torch.Tensor:
        return x.contiguous() if env_major else x.permute(order).contiguous()

    scal = planes = None
    if ext.n_scalars:
        scal = ext.pack_extra(env, states.extra)
        _require(tuple(scal.shape) == (n, ext.n_scalars), f"extra must pack to [{n}, {ext.n_scalars}]", what)
        scal = scal.to(device=device, dtype=torch.int32)
        # The kernel updates these in place: never the state's own tensor,
        # which a pack may return as it is (and a transposed [N, 1] pack is
        # contiguous already, so ``contiguous`` would not copy it either).
        scal = (scal if env_major else scal.t()).clone(memory_format=torch.contiguous_format)
    if ext.n_planes:
        planes = _plane_bytes(ext.pack_planes(env, states.extra), (n,), ext.n_planes, cells, device, what, env_major)
    if not ext.covers_reset:
        _require(reset_seeds is None, "a cached ext resets from its cache and takes no reset_seeds", what)
        r = cache.step_count.shape[1]
        cscal = cplanes = None
        if ext.n_scalars:
            cscal = ext.pack_extra(env, cache.extra)
            _require(
                tuple(cscal.shape) == (n, r, ext.n_scalars),
                f"the cache's extra must pack to [{n}, {r}, {ext.n_scalars}]",
                what,
            )
            cscal = minor(cscal.to(device=device, dtype=torch.int32), (1, 2, 0))
        if ext.n_planes:
            cplanes = _plane_bytes(ext.pack_planes(env, cache.extra), (n, r), ext.n_planes, cells, device, what, env_major)
        return ExtBuffers(scal, cscal, planes, cplanes, None, *ids, env_major)
    _require(
        reset_seeds is not None and tuple(reset_seeds.shape) == (n, 2)
        and reset_seeds.dtype == torch.int32 and reset_seeds.device == device,
        f"reset_seeds must be int32 [{n}, 2] on the state's device",
        what,
    )
    return ExtBuffers(scal, None, planes, None, minor(reset_seeds, (1, 0)), *ids, env_major)


def with_extra(env, final: EnvState, ext: ExtBuffers) -> EnvState:
    """``final`` with the kernel's final extra scalars and planes (widened
    back to int32) unpacked into its ``extra``."""
    if ext.scal is None and ext.planes is None:
        return final
    scal = ext.scal if ext.scal is None or ext.env_major else ext.scal.t().contiguous()
    if ext.planes is None:
        return final.replace(extra=env.fused_ext.unpack_extra(env, scal))
    planes = ext.planes if ext.env_major else ext.planes.permute(2, 0, 1)
    return final.replace(extra=env.fused_ext.unpack_extra(env, scal, planes.to(torch.int32).contiguous()))


def _launch(env, states: EnvState, cache, actions: torch.Tensor, compute_obs: bool, reset_seeds):
    global KERNEL_LAUNCHES
    r = check_env_and_state(env, states, cache, "fused_rollout")
    device = states.device
    n = states.step_count.shape[0]
    t = actions.shape[0]
    _require(actions.shape == (t, n), f"actions must be [T, {n}], got {tuple(actions.shape)}")
    _require(actions.dtype == torch.int32 and actions.device == device, "actions must be int32 on the state's device")
    b = kernel_buffers(env, states, cache, reset_seeds)
    ext = b.ext
    acts = actions.contiguous()
    used = torch.zeros(n, dtype=torch.int32, device=device)
    obs = torch.zeros_like(used)
    rew = torch.zeros(n, dtype=torch.float32, device=device)
    done = torch.zeros_like(used)

    lib = kernel_library("fused_rollout", env)
    _require(lib.fused_rollout_view() == env.agent_view_size, f"the library holds no view {env.agent_view_size}")
    fn = lib.fused_rollout_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            *(_pointer(x) for x in (acts, b.grid, b.cont, b.sc, b.mis, b.cgrid, b.ccont, *b.csc, b.cmis)),
            *ext.pointers(),
            *(_pointer(x) for x in (used, obs, rew, done)),
            env.width, env.height, env.agent_view_size, r, states.mission.shape[-1], t, n,
            0 if ext.scal is None else env.fused_ext.n_scalars,
            0 if ext.planes is None else env.fused_ext.n_planes,
            *kernel_flags(env),
            int(bool(compute_obs)),
            ext.ext_id,
            *ext.params,
            *ext.user,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_rollout kernel launch failed with CUDA error {err}")
    KERNEL_LAUNCHES += 1

    w, h = env.width, env.height
    final = _with_rows(states, b.grid.reshape(n, w, h), b.cont.reshape(n, w, h), b.sc, b.mis)
    return (
        with_extra(env, final, ext),
        rew.sum(),
        wrap_int32(done.sum(dtype=torch.int64)),
        wrap_int32(obs.sum(dtype=torch.int64)),
        torch.zeros((), dtype=torch.int32, device=device) if r == 0 else used.max(),
    )
