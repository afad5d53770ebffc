"""RedBlueDoors (reference: minigrid/envs/redbluedoors.py:62-127).

Counterpart of ``minigrid_tpu/envs/redbluedoors.py``.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import grid as g
from minigrid_tpu_torch.core import sampling as s_
from minigrid_tpu_torch.core.constants import COLOR_BLUE, COLOR_RED, OBJ_DOOR, STATE_CLOSED, STATE_OPEN, cell, cell_state
from minigrid_tpu_torch.core.env import MiniGridEnv
from minigrid_tpu_torch.core.mission import mission_vec, template_id
from minigrid_tpu_torch.core.state import EnvState, new_state
from minigrid_tpu_torch.core.step import success_reward
from minigrid_tpu_torch.ops import fused_ext as fx

_MISSION = mission_vec(template_id("open the red door then the blue door"))


class RedBlueDoorsFusedExt(fx.CachedExt):
    """RedBlueDoors' step overlay (``csrc/ext/red_blue_doors.cuh``; JAX:
    ``minigrid_tpu/envs/redbluedoors.py::_RedBlueDoorsFusedExt``): the blue
    door open after the red one succeeds; the blue one open first, or the
    red one opened after the blue one, fails.  The doors are read in the
    grids before and after the step (the kernels take a door's cell before
    the step from the front cell's value before it, ``FRONT_BEFORE``).
    Extra scalars: the red door's x and y, then the blue door's, blended
    from the reset cache."""

    n_scalars = 4
    kernel_id = 12
    # Objects, a per-episode mission, occluding walls.
    kernel_switches = (False, False, False)

    def pack_extra(self, env, extra):
        return torch.cat([extra["red_pos"], extra["blue_pos"]], dim=-1).to(torch.int32)

    def unpack_extra(self, env, scal):
        return {"red_pos": scal[..., 0:2], "blue_pos": scal[..., 2:4]}

    def post_step(self, env, prev, state, action, reward, scal):
        def is_open(grid, x, y):
            return cell_state(g.get_cell(grid, x, y)) == STATE_OPEN

        red_before = is_open(prev.grid, scal[:, 0], scal[:, 1])
        blue_before = is_open(prev.grid, scal[:, 2], scal[:, 3])
        red_after = is_open(state.grid, scal[:, 0], scal[:, 1])
        blue_after = is_open(state.grid, scal[:, 2], scal[:, 3])
        # Blue open succeeds iff red was already open (reference :114-120);
        # red opened after blue fails (:122-125).
        success = blue_after & red_before
        failure = (blue_after & ~red_before) | (red_after & ~blue_after & blue_before)
        reward = torch.where(success, success_reward(state.step_count, state.max_steps), torch.where(failure, 0.0, reward))
        return success | failure, reward, scal


class RedBlueDoorEnv(MiniGridEnv):
    """A double room: a red door on the inner left wall, a blue one on the
    right; the doors must be opened red first
    (reference: minigrid/envs/redbluedoors.py:81-127)."""

    fused_ext = RedBlueDoorsFusedExt()

    def __init__(self, size: int = 8, max_steps: int | None = None, **kwargs):
        if max_steps is None:
            max_steps = 20 * size**2
        super().__init__(width=2 * size, height=size, max_steps=max_steps, **kwargs)
        self.size = size

    def _generate(self, num_envs: int, generator: torch.Generator | None, device) -> EnvState:
        s, w, h, n = self.size, self.width, self.height, num_envs
        grid = g.wall_rect(g.empty_grid(n, w, h, device), 0, 0, 2 * s, s)
        grid = g.wall_rect(grid, s // 2, 0, s, s)
        agent = s_.place_obj_pos(generator, grid, top=(s // 2, 0), size=(s, s))
        agent_dir = s_.rand_dir(generator, n, device)
        red_y = s_.randint(generator, n, 1, s - 1, device)
        blue_y = s_.randint(generator, n, 1, s - 1, device)
        red = torch.stack([torch.full_like(red_y, s // 2), red_y], dim=-1)
        blue = torch.stack([torch.full_like(blue_y, s // 2 + s - 1), blue_y], dim=-1)
        grid = g.set_cell(grid, red[:, 0], red[:, 1], cell(OBJ_DOOR, COLOR_RED, STATE_CLOSED))
        grid = g.set_cell(grid, blue[:, 0], blue[:, 1], cell(OBJ_DOOR, COLOR_BLUE, STATE_CLOSED))
        return new_state(grid, agent, agent_dir, self.max_steps, mission=_MISSION, extra={"red_pos": red, "blue_pos": blue})

    def _post_step(self, prev, state, action, reward):
        return self.fused_ext.apply_post_step(self, prev, state, action, reward)
