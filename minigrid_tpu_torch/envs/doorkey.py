"""DoorKey (reference: minigrid/envs/doorkey.py:9-100)."""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import grid as g
from minigrid_tpu_torch.core import sampling as s
from minigrid_tpu_torch.core.constants import (
    COLOR_YELLOW,
    GOAL_CELL,
    OBJ_DOOR,
    OBJ_KEY,
    STATE_LOCKED,
    WALL_CELL,
    cell,
)
from minigrid_tpu_torch.core.env import MiniGridEnv
from minigrid_tpu_torch.core.mission import mission_vec, template_id
from minigrid_tpu_torch.core.state import EnvState, new_state

_MISSION_VEC = mission_vec(template_id("use the key to open the door and then get to the goal"))


class DoorKeyEnv(MiniGridEnv):
    """A room split by a wall with a locked yellow door; the yellow key lies
    on the agent's side (reference: minigrid/envs/doorkey.py:75-100).  The
    grid holds a key and a door, so neither kernel switch applies."""

    expensive_reset = True

    def __init__(self, size: int = 8, max_steps: int | None = None, **kwargs):
        if max_steps is None:
            max_steps = 10 * size**2
        super().__init__(width=size, height=size, max_steps=max_steps, **kwargs)

    def _generate(self, num_envs: int, generator: torch.Generator | None, device) -> EnvState:
        n, w, h = num_envs, self.width, self.height
        grid = g.wall_rect(g.empty_grid(n, w, h, device), 0, 0, w, h)
        grid = g.set_cell(grid, w - 2, h - 2, GOAL_CELL)
        # The splitting wall at a column in [2, w-2), per env.
        split = s.randint(generator, n, 2, w - 2, device)
        grid = g.put(grid, g.vert_wall_mask(w, h, split, 0), WALL_CELL)
        # The agent on a free cell strictly left of the wall.
        agent = s.place_obj_pos(generator, grid, size=(split, h))
        agent_dir = s.rand_dir(generator, n, device)
        # The locked door at a row in [1, h-2).
        door = s.randint(generator, n, 1, h - 2, device)
        grid = g.set_cell(grid, split, door, cell(OBJ_DOOR, COLOR_YELLOW, STATE_LOCKED))
        key = s.place_obj_pos(generator, grid, agent_pos=agent, size=(split, h))
        grid = g.set_cell(grid, key[:, 0], key[:, 1], cell(OBJ_KEY, COLOR_YELLOW))
        return new_state(grid, agent, agent_dir, self.max_steps, mission=_MISSION_VEC)
