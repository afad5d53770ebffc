"""Playground (reference: minigrid/envs/playground.py:10-91).

Counterpart of ``minigrid_tpu/envs/playground.py``.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import grid as g
from minigrid_tpu_torch.core import sampling as s_
from minigrid_tpu_torch.core.constants import OBJ_DOOR, SORTED_COLOR_IDX, STATE_CLOSED, WALL_CELL, cell
from minigrid_tpu_torch.core.env import MiniGridEnv
from minigrid_tpu_torch.core.mission import mission_vec, template_id
from minigrid_tpu_torch.core.roomgrid import KIND_TABLE
from minigrid_tpu_torch.core.state import EnvState, new_state

_MISSION = mission_vec(template_id(""))


class PlaygroundEnv(MiniGridEnv):
    """3x3 rooms joined by doors, with 12 random objects; no goal and no
    reward (reference: minigrid/envs/playground.py:31-91)."""

    def __init__(self, max_steps: int = 100, **kwargs):
        super().__init__(width=19, height=19, max_steps=max_steps, **kwargs)

    def _generate(self, num_envs: int, generator: torch.Generator | None, device) -> EnvState:
        w, h, n = self.width, self.height, num_envs
        room_w, room_h = w // 3, h // 3
        grid = g.wall_rect(g.empty_grid(n, w, h, device), 0, 0, w, h)
        colors = torch.tensor(SORTED_COLOR_IDX, dtype=torch.int32, device=device)
        kinds = torch.tensor(KIND_TABLE, dtype=torch.int32, device=device)

        def color():
            return colors[s_.randint(generator, n, 0, len(SORTED_COLOR_IDX), device).long()]

        # The rooms' walls, each with a door of a random color at a random
        # place (reference :45-65).
        for j in range(3):
            for i in range(3):
                xl, yt = i * room_w, j * room_h
                xr, yb = xl + room_w, yt + room_h
                if i + 1 < 3:
                    grid = g.put(grid, g.vert_wall_mask(w, h, xr, yt, room_h, device), WALL_CELL)
                    y = s_.randint(generator, n, yt + 1, yb - 1, device)
                    grid = g.set_cell(grid, xr, y, cell(OBJ_DOOR, color(), STATE_CLOSED))
                if j + 1 < 3:
                    grid = g.put(grid, g.horz_wall_mask(w, h, xl, yb, room_w, device), WALL_CELL)
                    x = s_.randint(generator, n, xl + 1, xr - 1, device)
                    grid = g.set_cell(grid, x, yb, cell(OBJ_DOOR, color(), STATE_CLOSED))
        agent = s_.place_obj_pos(generator, grid)
        agent_dir = s_.rand_dir(generator, n, device)
        # 12 random objects (reference :71-87).
        for _ in range(12):
            kind = kinds[s_.randint(generator, n, 0, len(KIND_TABLE), device).long()]
            pos = s_.place_obj_pos(generator, grid, agent_pos=agent)
            grid = g.set_cell(grid, pos[:, 0], pos[:, 1], cell(kind, color()))
        return new_state(grid, agent, agent_dir, self.max_steps, mission=_MISSION)
