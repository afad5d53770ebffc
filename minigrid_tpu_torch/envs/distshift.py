"""DistShift (reference: minigrid/envs/distshift.py:99-121).

Counterpart of ``minigrid_tpu/envs/distshift.py``.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import grid as g
from minigrid_tpu_torch.core.constants import GOAL_CELL, LAVA_CELL
from minigrid_tpu_torch.core.env import MiniGridEnv
from minigrid_tpu_torch.core.mission import mission_vec, template_id
from minigrid_tpu_torch.core.state import EnvState, new_state

_MISSION = mission_vec(template_id("get to the green goal square"))


class DistShiftEnv(MiniGridEnv):
    """Two lava strips; variant 1 has the second strip at row 2, variant 2
    at row 5 (reference: minigrid/envs/distshift.py:65-121)."""

    # A fixed layout and start: every level is the same (a 1-slot reset
    # cache reproduces the reference's stream).  The grid holds only walls,
    # lava and the goal, and the mission is a family constant.
    deterministic_generation = True
    fused_no_objects = True
    fused_static_mission = True

    def __init__(
        self,
        width: int = 9,
        height: int = 7,
        agent_start_pos: tuple[int, int] = (1, 1),
        agent_start_dir: int = 0,
        strip2_row: int = 2,
        max_steps: int | None = None,
        **kwargs,
    ):
        if max_steps is None:
            max_steps = 4 * width * height
        super().__init__(width=width, height=height, max_steps=max_steps, see_through_walls=True, **kwargs)
        self.agent_start_pos = agent_start_pos
        self.agent_start_dir = agent_start_dir
        self.goal_pos = (width - 2, 1)
        self.strip2_row = strip2_row

    def _generate(self, num_envs: int, generator: torch.Generator | None, device) -> EnvState:
        w, h = self.width, self.height
        grid = g.wall_rect(g.empty_grid(num_envs, w, h, device), 0, 0, w, h)
        grid = g.set_cell(grid, self.goal_pos[0], self.goal_pos[1], GOAL_CELL)
        strip_len = w - 6
        grid = g.put(grid, g.horz_wall_mask(w, h, 3, 1, strip_len, device), LAVA_CELL)
        grid = g.put(grid, g.horz_wall_mask(w, h, 3, self.strip2_row, strip_len, device), LAVA_CELL)
        return new_state(grid, self.agent_start_pos, self.agent_start_dir, self.max_steps, mission=_MISSION)
