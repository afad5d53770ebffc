"""FourRooms (reference: minigrid/envs/fourrooms.py:9-127)."""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import grid as g
from minigrid_tpu_torch.core import sampling as s
from minigrid_tpu_torch.core.constants import EMPTY_CELL, GOAL_CELL, WALL_CELL
from minigrid_tpu_torch.core.env import MiniGridEnv
from minigrid_tpu_torch.core.mission import mission_vec, template_id
from minigrid_tpu_torch.core.state import EnvState, new_state

_MISSION_VEC = mission_vec(template_id("reach the goal"))


class FourRoomsEnv(MiniGridEnv):
    """2x2 rooms with one gap at a random place in each inner wall
    (reference: minigrid/envs/fourrooms.py:79-127).  The grid holds walls
    and the goal only, and the mission is a family constant."""

    expensive_reset = True
    fused_no_objects = True
    fused_static_mission = True

    def __init__(
        self,
        agent_pos: tuple[int, int] | None = None,
        goal_pos: tuple[int, int] | None = None,
        size: int = 19,
        max_steps: int = 100,
        **kwargs,
    ):
        super().__init__(width=size, height=size, max_steps=max_steps, **kwargs)
        self._agent_default_pos = agent_pos
        self._goal_default_pos = goal_pos

    def _generate(self, num_envs: int, generator: torch.Generator | None, device) -> EnvState:
        n, w, h = num_envs, self.width, self.height
        room_w, room_h = w // 2, h // 2
        grid = g.wall_rect(g.empty_grid(n, w, h, device), 0, 0, w, h)
        # The inner walls, each with one gap (reference :93-111).
        walls = (
            g.vert_wall_mask(w, h, room_w, 0, room_h, device)
            | g.horz_wall_mask(w, h, 0, room_h, room_w, device)
            | g.horz_wall_mask(w, h, room_w, room_h, room_w, device)
            | g.vert_wall_mask(w, h, room_w, room_h, room_h, device)
        )
        grid = g.put(grid, walls, WALL_CELL)
        gap0 = s.randint(generator, n, 1, room_h, device)  # (room_w, gap0)
        gap1 = s.randint(generator, n, 1, room_w, device)  # (gap1, room_h)
        gap2 = s.randint(generator, n, room_w + 1, 2 * room_w, device)  # (gap2, room_h)
        gap3 = s.randint(generator, n, room_h + 1, 2 * room_h, device)  # (room_w, gap3)
        for x, y in ((room_w, gap0), (gap1, room_h), (gap2, room_h), (room_w, gap3)):
            grid = g.set_cell(grid, x, y, EMPTY_CELL)

        if self._agent_default_pos is not None:
            ax, ay = self._agent_default_pos
            grid = g.set_cell(grid, ax, ay, EMPTY_CELL)
            agent = torch.tensor([ax, ay], dtype=torch.int32, device=device).expand(n, 2)
        else:
            agent = s.place_obj_pos(generator, grid)
        agent_dir = s.rand_dir(generator, n, device)
        if self._goal_default_pos is not None:
            grid = g.set_cell(grid, *self._goal_default_pos, GOAL_CELL)
        else:
            goal = s.place_obj_pos(generator, grid, agent_pos=agent)
            grid = g.set_cell(grid, goal[:, 0], goal[:, 1], GOAL_CELL)
        return new_state(grid, agent, agent_dir, self.max_steps, mission=_MISSION_VEC)
