"""Batched egocentric observation.

Same semantics as ``minigrid_tpu/core/obs.py`` (the reference's slice, rotate,
occlusion sweep and encode: minigrid/minigrid_env.py:597-650,
minigrid/core/grid.py:110-143, :291-328).  The packed view goes through
``ops/obs_packed.fused_obs_packed``: on CUDA tensors the observation kernel
(K4), on CPU tensors its plain PyTorch version, whose pieces
(``view_world_coords``, ``extract_view``, ``process_vis``) live there and
are re-exported here.

``gen_obs_packed(..., plain=True)`` (and ``MiniGridEnv.observation_packed``'s
``plain``) asks for the plain version on any device: the references the
kernels are held to on the card observe that way.  ``plain_observations()``
does the same for every observation made inside it; it is a hook for checks
that drive a whole ``env.step`` loop or a wrapper through the plain version,
not a user option.
"""

from __future__ import annotations

import contextlib
import contextvars

from minigrid_tpu_torch.core.constants import unpack_grid
from minigrid_tpu_torch.core.state import EnvState
from minigrid_tpu_torch.ops.obs_packed import (
    extract_view,
    fused_obs_packed,
    fused_obs_packed_reference,
    process_vis,
    view_and_vis_packed,
    view_world_coords,
)

__all__ = [
    "extract_view",
    "gen_obs",
    "gen_obs_image",
    "gen_obs_packed",
    "process_vis",
    "view_and_vis",
    "view_world_coords",
]

_PLAIN = contextvars.ContextVar("plain_observations", default=False)


@contextlib.contextmanager
def plain_observations():
    """Within the block (in this thread or task), every observation made
    through this module (the env's ``observation`` and
    ``observation_packed``, the wrappers and the frames) takes the plain
    version on any device.  A hook for the checks that hold an ``env.step``
    loop or a wrapper to the plain version, where no direct call exists."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def view_and_vis(state: EnvState, view_size: int, see_through_walls: bool):
    """Packed int32[N, v, v] view with the carried object (or empty) at the
    agent cell, and its bool[N, v, v] visibility (the plain version)."""
    return view_and_vis_packed(
        state.grid, state.agent_x, state.agent_y, state.agent_dir, state.carrying, view_size, see_through_walls
    )


def gen_obs_packed(state: EnvState, view_size: int, see_through_walls: bool, plain: bool = False):
    """int32[N, v, v] packed observation; invisible cells are 0 ("unseen").
    ``plain`` takes the plain version on any device."""
    fn = fused_obs_packed_reference if plain or _PLAIN.get() else fused_obs_packed
    return fn(state.grid, state.agent_x, state.agent_y, state.agent_dir, state.carrying, view_size, see_through_walls)


def gen_obs_image(state: EnvState, view_size: int, see_through_walls: bool):
    """uint8[N, v, v, 3] encoded observation (minigrid/minigrid_env.py:597-650)."""
    return unpack_grid(gen_obs_packed(state, view_size, see_through_walls))


def gen_obs(state: EnvState, view_size: int, see_through_walls: bool, image: bool = True):
    """Observation dict of every env; without its ``"image"`` where
    ``image`` is false (for a wrapper that replaces the image: eager
    PyTorch, unlike XLA under jit, would compute a view it then drops)."""
    rest = {"direction": state.agent_dir, "mission": state.mission}
    return {"image": gen_obs_image(state, view_size, see_through_walls), **rest} if image else rest
