"""MultiRoom (reference: minigrid/envs/multiroom.py:18-279).

Counterpart of ``minigrid_tpu/envs/multiroom.py``.  The reference places a
chain of connected rooms with a recursive routine whose failed child
placement is retried up to 8 times and never unwinds further, inside a
loop that starts over until a chain of the drawn length fits.  Here one
chain attempt is a walk over the rooms of N envs at once, each room with
up to 8 placement attempts; the envs whose chain fell short draw new
chains, and only they, as BabyAI's rejection loop does
(``envs/babyai/core/level.py``).
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import grid as g
from minigrid_tpu_torch.core import sampling as s_
from minigrid_tpu_torch.core.constants import GOAL_CELL, OBJ_DOOR, SORTED_COLOR_IDX, STATE_CLOSED, WALL_CELL, cell
from minigrid_tpu_torch.core.env import MiniGridEnv
from minigrid_tpu_torch.core.mission import mission_vec, template_id
from minigrid_tpu_torch.core.state import EnvState, new_state

_MISSION = mission_vec(template_id("traverse the rooms to get to the goal"))
# Chain attempts per level after the first, as the JAX package bounds them,
# drawn CHAINS_PER_RETRY at a time for each level still short (the first
# that fits is kept: attempts are independent, so it is an accepted chain).
# One in five N6 chains fits, so a round of one chain a level would leave
# 79% of the levels to the next round.
MAX_CHAIN_RETRIES = 200
CHAINS_PER_RETRY = 8
# Placement attempts per room (reference :237).
ROOM_ATTEMPTS = 8
MIN_ROOM_SIZE = 4


class MultiRoomEnv(MiniGridEnv):
    """A chain of rooms joined by doors of changing colors; the goal in the
    last room (reference: minigrid/envs/multiroom.py:112-279)."""

    expensive_reset = True

    def __init__(self, minNumRooms: int, maxNumRooms: int, maxRoomSize: int = 10, max_steps: int | None = None, **kwargs):
        if not (0 < minNumRooms <= maxNumRooms and maxRoomSize >= MIN_ROOM_SIZE):
            raise ValueError(f"need 0 < minNumRooms <= maxNumRooms and maxRoomSize >= {MIN_ROOM_SIZE}")
        self.min_rooms = minNumRooms
        self.max_rooms = maxNumRooms
        self.max_room_size = maxRoomSize
        if max_steps is None:
            max_steps = maxNumRooms * 20
        super().__init__(width=25, height=25, max_steps=max_steps, **kwargs)

    def _try_chain(self, generator, num_rooms: torch.Tensor):
        """One chain attempt per env (the reference's _placeRoom recursion,
        :186-279): room k is placed against room k-1's exit wall, up to 8
        attempts each, the first room once at a random corner.  Returns the
        rooms' tops, sizes and entry doors (int32 [N, R, 2]) and the number
        of rooms placed (int32 [N])."""
        n, device = num_rooms.shape[0], num_rooms.device
        w, h, r = self.width, self.height, self.max_rooms
        lo, hi = MIN_ROOM_SIZE, self.max_room_size + 1
        tops = torch.zeros((n, r, 2), dtype=torch.int32, device=device)
        sizes = torch.zeros_like(tops)
        entries = torch.zeros_like(tops)
        first_top = torch.stack([s_.randint(generator, n, 0, w - 2, device), s_.randint(generator, n, 0, w - 2, device)], -1)
        entry_wall = torch.full((n,), 2, dtype=torch.int32, device=device)  # the first room is entered from the left
        count = torch.zeros(n, dtype=torch.int32, device=device)
        alive = torch.ones(n, dtype=torch.bool, device=device)
        for k in range(r):
            placed = torch.zeros(n, dtype=torch.bool, device=device)
            ptop, psize = tops[:, max(k - 1, 0)], sizes[:, max(k - 1, 0)]
            for _ in range(ROOM_ATTEMPTS if k > 0 else 1):
                sx, sy = s_.randint(generator, n, lo, hi, device), s_.randint(generator, n, lo, hi, device)
                if k == 0:
                    top, door, new_wall = first_top, torch.zeros_like(first_top), entry_wall
                else:
                    # The exit wall: uniform over the walls but the entry one (:243-246).
                    r3 = s_.randint(generator, n, 0, 3, device)
                    exit_wall = r3 + (r3 >= entry_wall).int()
                    new_wall = (exit_wall + 2) % 4
                    # The door on room k-1's exit wall (:248-262).
                    along_y = (exit_wall == 0) | (exit_wall == 2)
                    off = s_.randint(generator, n, 1, torch.where(along_y, psize[:, 1], psize[:, 0]) - 1)
                    dx = torch.where(exit_wall == 0, ptop[:, 0] + psize[:, 0] - 1, torch.where(exit_wall == 2, ptop[:, 0], ptop[:, 0] + off))
                    dy = torch.where(exit_wall == 1, ptop[:, 1] + psize[:, 1] - 1, torch.where(exit_wall == 3, ptop[:, 1], ptop[:, 1] + off))
                    # The room's top from its entry wall (:191-215).
                    u = s_.randint(generator, n, 0, (sx - 2).clamp(min=1))
                    v = s_.randint(generator, n, 0, (sy - 2).clamp(min=1))
                    tx = torch.where(new_wall == 0, dx - sx + 1, torch.where(new_wall == 2, dx, dx - sx + 2 + u))
                    ty = torch.where(new_wall == 1, dy - sy + 1, torch.where(new_wall == 3, dy, dy - sy + 2 + v))
                    top, door = torch.stack([tx, ty], -1), torch.stack([dx, dy], -1)
                # In bounds, the height strictly (:217-221), and clear of
                # rooms 0..k-2 (:223-233).
                ok = (top[:, 0] >= 0) & (top[:, 1] >= 0) & (top[:, 0] + sx <= w) & (top[:, 1] + sy < h)
                if k >= 2:
                    ot, os_ = tops[:, : k - 1], sizes[:, : k - 1]
                    apart = (
                        (top[:, None, 0] + sx[:, None] < ot[..., 0])
                        | (ot[..., 0] + os_[..., 0] <= top[:, None, 0])
                        | (top[:, None, 1] + sy[:, None] < ot[..., 1])
                        | (ot[..., 1] + os_[..., 1] <= top[:, None, 1])
                    )
                    ok = ok & apart.all(dim=1)
                do = (alive & ~placed & ok)[:, None]
                tops[:, k] = torch.where(do, top, tops[:, k])
                sizes[:, k] = torch.where(do, torch.stack([sx, sy], -1), sizes[:, k])
                entries[:, k] = torch.where(do, door, entries[:, k])
                entry_wall = torch.where(do[:, 0], new_wall, entry_wall)
                placed = placed | do[:, 0]
            count = count + (placed & (count == k)).int()
            alive = alive & placed & (count < num_rooms)
        return tops, sizes, entries, count

    def _generate(self, num_envs: int, generator: torch.Generator | None, device) -> EnvState:
        w, h, r, n = self.width, self.height, self.max_rooms, num_envs
        num_rooms = s_.randint(generator, n, self.min_rooms, self.max_rooms + 1, device)
        tops, sizes, entries, count = self._try_chain(generator, num_rooms)
        # Start over, for the envs whose chain fell short (reference :118-134).
        k = CHAINS_PER_RETRY
        for _ in range(MAX_CHAIN_RETRIES // k):
            redo = torch.nonzero(count < num_rooms, as_tuple=True)[0]
            if redo.numel() == 0:
                break
            t2, s2, e2, c2 = self._try_chain(generator, num_rooms[redo].repeat_interleave(k))
            fits = (c2 >= num_rooms[redo].repeat_interleave(k)).view(-1, k)
            first = torch.where(fits.any(dim=1), fits.int().argmax(dim=1), k - 1)
            pick = torch.arange(redo.numel(), device=device) * k + first
            tops, sizes, entries = (a.index_copy(0, redo, b[pick]) for a, b in ((tops, t2), (sizes, s2), (entries, e2)))
            count = count.index_copy(0, redo, c2[pick])
        # The rooms in order, walls and then the entry door, whose color
        # differs from the previous door's (reference :146-176).
        table = torch.tensor(SORTED_COLOR_IDX, dtype=torch.int32, device=device)
        grid = g.empty_grid(n, w, h, device)
        prev = torch.full((n,), -1, dtype=torch.int32, device=device)
        for k in range(r):
            active = (k < count)[:, None, None]
            tx, ty, sx, sy = tops[:, k, 0], tops[:, k, 1], sizes[:, k, 0], sizes[:, k, 1]
            outline = g.rect_mask(w, h, tx, ty, sx, sy) & ~g.rect_mask(w, h, tx + 1, ty + 1, sx - 2, sy - 2)
            grid = g.put(grid, outline & active, WALL_CELL)
            r6 = s_.randint(generator, n, 0, 6, device)
            r5 = s_.randint(generator, n, 0, 5, device)
            pos = torch.where(prev < 0, r6, r5 + (r5 >= prev).int())
            draw = (k < count) & (k > 0)
            door = g.set_cell(grid, entries[:, k, 0], entries[:, k, 1], cell(OBJ_DOOR, table[pos.long()], STATE_CLOSED))
            grid = torch.where(draw[:, None, None], door, grid)
            prev = torch.where(draw, pos, prev)
        # The agent in the first room, the goal in the last (reference :179-182).
        agent = s_.place_obj_pos(generator, grid, top=(tops[:, 0, 0], tops[:, 0, 1]), size=(sizes[:, 0, 0], sizes[:, 0, 1]))
        agent_dir = s_.rand_dir(generator, n, device)
        rows, last = torch.arange(n, device=device), (count - 1).clamp(min=0).long()
        lt, ls = tops[rows, last], sizes[rows, last]
        goal_mask = g.free_mask(grid, agent) & g.rect_mask(w, h, lt[:, 0], lt[:, 1], ls[:, 0], ls[:, 1])
        goal = s_.sample_mask_cell(generator, goal_mask)
        grid = g.set_cell(grid, goal[:, 0], goal[:, 1], GOAL_CELL)
        return new_state(grid, agent, agent_dir, self.max_steps, mission=_MISSION)
