"""LavaGap (reference: minigrid/envs/lavagap.py:101-136).

Counterpart of ``minigrid_tpu/envs/lavagap.py``.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import grid as g
from minigrid_tpu_torch.core import sampling as s_
from minigrid_tpu_torch.core.constants import EMPTY_CELL, GOAL_CELL, LAVA_CELL, WALL_CELL
from minigrid_tpu_torch.core.env import MiniGridEnv
from minigrid_tpu_torch.core.mission import mission_vec, template_id
from minigrid_tpu_torch.core.state import EnvState, new_state

_MISSIONS = {
    "lava": mission_vec(template_id("avoid the lava and get to the green goal square")),
    "wall": mission_vec(template_id("find the opening and get to the green goal square")),
}


class LavaGapEnv(MiniGridEnv):
    """A vertical obstacle wall with one gap
    (reference: minigrid/envs/lavagap.py:75-136)."""

    # The grid holds only walls, lava and the goal, and the mission depends
    # only on the obstacle type.
    fused_no_objects = True
    fused_static_mission = True

    def __init__(self, size: int, obstacle_type: str = "lava", max_steps: int | None = None, **kwargs):
        if max_steps is None:
            max_steps = 4 * size**2
        super().__init__(width=size, height=size, max_steps=max_steps, see_through_walls=False, **kwargs)
        if obstacle_type not in _MISSIONS:
            raise ValueError(f"obstacle_type must be 'lava' or 'wall', got {obstacle_type!r}")
        self.obstacle_type = obstacle_type

    def _generate(self, num_envs: int, generator: torch.Generator | None, device) -> EnvState:
        w, h, n = self.width, self.height, num_envs
        grid = g.wall_rect(g.empty_grid(n, w, h, device), 0, 0, w, h)
        grid = g.set_cell(grid, w - 2, h - 2, GOAL_CELL)
        gap_x = s_.randint(generator, n, 2, w - 2, device)
        gap_y = s_.randint(generator, n, 1, h - 1, device)
        obstacle = LAVA_CELL if self.obstacle_type == "lava" else WALL_CELL
        grid = g.put(grid, g.vert_wall_mask(w, h, gap_x, 1, h - 2), obstacle)
        grid = g.set_cell(grid, gap_x, gap_y, EMPTY_CELL)
        return new_state(grid, (1, 1), 0, self.max_steps, mission=_MISSIONS[self.obstacle_type])
