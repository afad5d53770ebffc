"""LockedRoom (reference: minigrid/envs/lockedroom.py:24-174).

Counterpart of ``minigrid_tpu/envs/lockedroom.py``.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import grid as g
from minigrid_tpu_torch.core import sampling as s_
from minigrid_tpu_torch.core.constants import (
    GOAL_CELL,
    OBJ_DOOR,
    OBJ_KEY,
    SORTED_COLOR_IDX,
    STATE_CLOSED,
    STATE_LOCKED,
    WALL_CELL,
    cell,
)
from minigrid_tpu_torch.core.env import MiniGridEnv
from minigrid_tpu_torch.core.mission import mission_rows, template_id
from minigrid_tpu_torch.core.state import EnvState, new_state
from minigrid_tpu_torch.envs.gotoobject import permutation_prefix

_MISSION = template_id(
    "get the {0} key from the {1} room, unlock the {2} door and go to the goal", ("color", "color", "color")
)


class LockedRoomEnv(MiniGridEnv):
    """A fixed 19x19 layout: 2x3 rooms on both sides of a central hallway;
    one room is locked and holds the goal, its key lies in another room
    (reference: minigrid/envs/lockedroom.py:95-174)."""

    expensive_reset = True

    def __init__(self, size: int = 19, max_steps: int | None = None, **kwargs):
        if max_steps is None:
            max_steps = 10 * size
        super().__init__(width=size, height=size, max_steps=max_steps, **kwargs)
        # The static room geometry (reference :109-131).
        self.l_wall = size // 2 - 2
        self.r_wall = size // 2 + 2
        self.room_size_wh = (self.l_wall + 1, size // 3 + 1)
        tops, doors = [], []
        for k in range(3):
            j = k * (size // 3)
            tops += [(0, j), (self.r_wall, j)]
            doors += [(self.l_wall, j + 3), (self.r_wall, j + 3)]
        self.room_tops = tuple(tops)
        self.door_positions = tuple(doors)

    def _generate(self, num_envs: int, generator: torch.Generator | None, device) -> EnvState:
        w, h, n = self.width, self.height, num_envs
        grid = g.wall_rect(g.empty_grid(n, w, h, device), 0, 0, w, h)
        # The hallway's walls and the rooms' (reference :109-124).
        grid = g.put(grid, g.vert_wall_mask(w, h, self.l_wall, 0, device=device), WALL_CELL)
        grid = g.put(grid, g.vert_wall_mask(w, h, self.r_wall, 0, device=device), WALL_CELL)
        for k in range(3):
            j = k * (h // 3)
            grid = g.put(grid, g.horz_wall_mask(w, h, 0, j, self.l_wall, device), WALL_CELL)
            grid = g.put(grid, g.horz_wall_mask(w, h, self.r_wall, j, w - self.r_wall, device), WALL_CELL)
        room_w, room_h = self.room_size_wh
        tops = torch.tensor(self.room_tops, dtype=torch.int32, device=device)
        # The locked room and the goal inside it, at a uniform interior cell
        # with no emptiness check (reference :133-137).
        locked = s_.randint(generator, n, 0, 6, device).long()
        gx = tops[locked, 0] + 1 + s_.randint(generator, n, 0, room_w - 2, device)
        gy = tops[locked, 1] + 1 + s_.randint(generator, n, 0, room_h - 2, device)
        grid = g.set_cell(grid, gx, gy, GOAL_CELL)
        # The doors' colors: a uniform permutation of the six (reference
        # :139-147 takes each drawn color out of the pool).
        table = torch.tensor(SORTED_COLOR_IDX, dtype=torch.int32, device=device)
        colors = table[permutation_prefix(generator, n, len(SORTED_COLOR_IDX), len(SORTED_COLOR_IDX), device)]
        rows = torch.arange(n, device=device)
        for r in range(6):
            state = torch.where(locked == r, STATE_LOCKED, STATE_CLOSED).int()
            grid = g.set_cell(grid, self.door_positions[r][0], self.door_positions[r][1], cell(OBJ_DOOR, colors[:, r], state))
        locked_color = colors[rows, locked]
        # The key, of the locked room's color, in another room at a uniform
        # interior cell (reference :150-156).
        key_room = (locked + 1 + s_.randint(generator, n, 0, 5, device)) % 6
        kx = tops[key_room, 0] + 1 + s_.randint(generator, n, 0, room_w - 2, device)
        ky = tops[key_room, 1] + 1 + s_.randint(generator, n, 0, room_h - 2, device)
        grid = g.set_cell(grid, kx, ky, cell(OBJ_KEY, locked_color))
        # The agent in the hallway (reference :159-161).
        hall = g.rect_mask(w, h, self.l_wall, 0, self.r_wall - self.l_wall, h, device)
        agent = s_.sample_mask_cell(generator, g.free_mask(grid) & hall)
        agent_dir = s_.rand_dir(generator, n, device)
        return new_state(
            grid,
            agent,
            agent_dir,
            self.max_steps,
            mission=mission_rows(_MISSION, locked_color, colors[rows, key_room], locked_color),
        )
