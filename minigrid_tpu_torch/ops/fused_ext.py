"""Family extensions of the whole-rollout kernel: the Python side.

Counterpart of ``minigrid_tpu/ops/fused_ext.py``.  The kernel
(``csrc/fused_rollout.cu``) natively runs the default-hook transition.  A
family whose dynamics differ (``_pre_step``, ``_map_action``,
``_post_step``) or whose levels the kernel regenerates itself
(``covers_reset``) publishes a ``FusedExt``: a twin of its hooks compiled
into the kernel (``csrc/ext/*.cuh``, picked by ``kernel_id``), the packing
of its ``EnvState.extra`` into int32 per-env scalars and, for BabyAI's
verifier, extra planes of W*H cells, and the plain PyTorch version of its
in-kernel level generator, ``reset_block``.  A family that keeps its reset
cache (``covers_reset`` False) and carries extra scalars and planes has
them blended from the cache at every reset, with the rest of the level
(``CachedExt``); its post-step hook has a plain twin, ``post_step``, that
the family's ``_post_step`` runs (GoToObject, GoToDoor, Fetch) or that a
test holds to the plain step it mirrors (BabyAI's ``verify_step``).

A family written outside the package brings its twin as a header of its
own (``kernel_source``, the struct in it ``kernel_struct``, ``kernel_id``
``EXT_USER``): the kernels' wrappers build it into the rollout kernels at
first use (``ops/_build.load_library``), and its Python hooks stay the
plain twin: a cached ext, or a counter-reset one (``covers_reset``) whose
``reset`` writes the grid, contents, mission, extra scalars and planes that
its ``reset_block`` makes, with its own by-value values (``user_params``,
e.g. a mission's template id) in ``ExtParams::user``.

The counter-reset stream: every episode of an env draws from
``episode_seed(seed, ordinal)``, where ``seed`` is two int32 words fixed per
env for a rollout and ``ordinal`` counts the env's resets so far; placement
draws within the episode are ``place_draw(episode_seed, j)``.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core.constants import EMPTY_CELL, WALL_CELL
from minigrid_tpu_torch.core.state import EnvState
from minigrid_tpu_torch.ops.prng import threefry2x32

# Domain-separation tags of the counter-reset stream (the JAX package's
# values): the episode sub-seed hashes the ordinal with RESET_TAG, and
# placement draws use PLACE_TAG as the first counter word, so they never
# collide with the obstacle walk's (step_count, i) counters.
RESET_TAG = 0x72657365  # "rese"
PLACE_TAG = 0x706C6163  # "plac"
# The kernel id of an ext whose twin is a header outside the package
# (``csrc/fused_ext.cuh``'s EXT_USER).
EXT_USER = 100
# The by-value slots such a family has in the kernels' parameters
# (``csrc/fused_ext.cuh``'s USER_SLOTS).
USER_SLOTS = 4


class FusedExt:
    """Base family extension: no extra state, identity hooks.

    ``kernel_id`` names the compiled CUDA twin (``csrc/fused_ext.cuh``,
    ``EXT_*``), or is None where the kernel has none, and then the kernel's
    wrapper raises for the family.  ``pack_extra``/``unpack_extra`` are
    mutually inverse and take any leading batch shape.
    """

    n_scalars: int = 0  # int32 per-env extra scalars carried by the kernel
    # Per-env extra planes of W*H cells, each value in [0, 256): the kernels
    # carry them as bytes, env-minor, and blend them from the reset cache.
    n_planes: int = 0
    # The family's ``_pre_step`` is the kernel's ``pre_step`` hook.
    covers_pre_step: bool = False
    # The kernel regenerates a fresh level at every episode end from the
    # counter stream (``reset_block``), with no reset cache.
    covers_reset: bool = False
    kernel_id: int | None = None
    # A family written outside the package: the path of its CUDA header and
    # the struct in it (deriving from ``NoExt`` with ``load``, ``store``,
    # ``map_action``, ``post_step``, ``pre_step``, ``reset`` or
    # ``params_ok`` and ``MAX_K``, ``NUM_PLANES``, ``SWITCHES``,
    # ``FRONT_BEFORE``, ``PRE_STEP``, ``COUNTER_RESET`` as it needs, as the
    # headers of ``csrc/ext/`` do); ``kernel_id`` is then ``EXT_USER``.
    kernel_source: str | None = None
    kernel_struct: str | None = None
    # The kernel switches (no objects, static mission, see-through walls)
    # the compiled twin is instantiated at, None where it takes both: its
    # twin's ``SWITCHES`` (``csrc/fused_ext.cuh``).
    kernel_switches: tuple[bool | None, bool | None, bool | None] = (None, None, None)

    def pack_extra(self, env, extra) -> torch.Tensor | None:
        """``extra`` (leaves [..., inner]) -> int32 [..., n_scalars]."""
        return None

    def pack_planes(self, env, extra) -> torch.Tensor | None:
        """``extra`` -> int32 [..., n_planes, W*H] (cell (x, y) at x*H + y),
        or None without planes."""
        return None

    def unpack_extra(self, env, scal: torch.Tensor | None, planes: torch.Tensor | None = None):
        """Inverse of ``pack_extra`` and ``pack_planes``."""
        return None

    def kernel_params(self, env) -> tuple[int, ...] | None:
        """The kernel's by-value family parameters (``ExtParams`` in
        ``csrc/fused_ext.cuh``): max_steps, n_obstacles, num_crossings,
        obstacle_cell, start_x, start_y (-1: a random start), start_dir; or
        None where the family's sizes exceed the compiled slots."""
        return (env.max_steps, 0, 0, 0, -1, -1, 0)

    def user_params(self, env) -> tuple[int, ...]:
        """A family written outside the package: its own by-value values,
        at most ``USER_SLOTS`` ints, which its header reads as
        ``p.user[i]`` (zero past those given); e.g. the template id that
        ``register_mission`` handed out."""
        return ()

    def post_step(self, env, prev: EnvState, state: EnvState, action, reward, scal):
        """Plain twin of the kernel's post-step hook (``Ext::post_step`` on a
        ``StepCtx``, ``csrc/fused_ext.cuh``): ``prev`` and ``state`` are the
        states before and after the core step, ``action`` the unmapped
        action, ``reward`` the core step's and ``scal`` the packed extra
        scalars int32 [N, K].  Returns (extra termination bool [N], reward,
        scal); an ext with planes takes them after ``scal`` (int32 [N, P,
        W*H]) and returns them last."""
        return torch.zeros_like(state.terminated), reward, scal

    def apply_post_step(self, env, prev: EnvState, state: EnvState, action, reward):
        """``post_step`` on whole states: the family's ``_post_step``."""
        scal = self.pack_extra(env, state.extra)
        if self.n_planes:
            planes = self.pack_planes(env, state.extra)
            term, reward, scal, planes = self.post_step(env, prev, state, action, reward, scal, planes)
            extra = self.unpack_extra(env, scal, planes)
        else:
            term, reward, scal = self.post_step(env, prev, state, action, reward, scal)
            extra = state.extra if scal is None else self.unpack_extra(env, scal)
        return state.replace(terminated=state.terminated | term, extra=extra), reward

    def reset_block(self, env, seeds: torch.Tensor, ep_idx: torch.Tensor) -> EnvState:
        """Fresh episodes from the counter stream (``covers_reset`` only):
        ``seeds`` int32 [N, 2], ``ep_idx`` the episode ordinals [N].  The
        plain version of the kernel's reset, bit for bit."""
        raise NotImplementedError


def user_slots(ext: FusedExt, env) -> tuple[int, ...]:
    """``ext.user_params(env)`` padded with zeros to ``USER_SLOTS``, as the
    kernels take them; ValueError for more."""
    values = tuple(int(v) for v in ext.user_params(env))
    if len(values) > USER_SLOTS:
        raise ValueError(f"{type(ext).__name__}.user_params gives {len(values)} values; the kernels hold {USER_SLOTS}")
    return values + (0,) * (USER_SLOTS - len(values))


class CachedExt(FusedExt):
    """An ext whose levels come from the reset cache, its extra scalars and
    planes blended from the cache slot with the rest of the level."""


def episode_seed(seeds: torch.Tensor, ep_idx) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-episode sub-seed (two uint32 words in int64) of per-env
    ``seeds`` int32 [N, 2] at episode ordinals ``ep_idx`` [N]."""
    return threefry2x32(seeds[:, 0], seeds[:, 1], ep_idx, RESET_TAG)


def place_draw(e0: torch.Tensor, e1: torch.Tensor, j: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The j-th pair of placement words of an episode."""
    return threefry2x32(e0, e1, PLACE_TAG, j)


def place_words(e0: torch.Tensor, e1: torch.Tensor, count: int) -> list[torch.Tensor]:
    """The first ``count`` placement words of an episode, in draw order."""
    words: list[torch.Tensor] = []
    for j in range((count + 1) // 2):
        words.extend(place_draw(e0, e1, j))
    return words[:count]


def nth_true_index(m: torch.Tensor, target: torch.Tensor, fallback) -> torch.Tensor:
    """Per row of bool [N, C] ``m``, the index of its ``target``-th (0-based)
    set entry, or ``fallback`` where the row has no more than ``target``
    set entries.  Returns int64 [N]."""
    hit = m & (m.long().cumsum(dim=1) - 1 == target[:, None])
    return torch.where(hit.any(dim=1), hit.long().argmax(dim=1), torch.as_tensor(fallback).long())


def walled_plane(n: int, width: int, height: int, device, extra_cells=()) -> torch.Tensor:
    """Packed grids int32 [N, W*H] (cell (x, y) at x*H + y): border walls,
    empty inside, then the (x, y, cell) ``extra_cells``."""
    xs = torch.arange(width, device=device)[:, None]
    ys = torch.arange(height, device=device)[None, :]
    border = (xs == 0) | (ys == 0) | (xs == width - 1) | (ys == height - 1)
    plane = torch.where(border, WALL_CELL, EMPTY_CELL).to(torch.int32).reshape(-1)
    for x, y, cell in extra_cells:
        plane[x * height + y] = cell
    return plane.expand(n, -1).clone()
