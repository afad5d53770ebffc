"""BabyAI Unlock levels (reference: minigrid/envs/babyai/unlock.py).

Counterpart of ``minigrid_tpu/envs/babyai/unlock.py`` (BabyAI's classes;
the classic Unlock, UnlockPickup and BlockedUnlockPickup are
``envs/unlock.py``): each level's ``gen_attempt`` builds N attempts at once
from the caller's ``torch.Generator``.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import sampling as s_
from minigrid_tpu_torch.core.constants import (
    OBJ_BALL,
    OBJ_BOX,
    OBJ_DOOR,
    OBJ_KEY,
    SORTED_COLOR_IDX,
    STATE_LOCKED,
    cell,
    cell_color,
    cell_state,
    cell_type,
)
from minigrid_tpu_torch.core.grid import set_cell
from minigrid_tpu_torch.envs.babyai.core.instr import LEAF_OPEN, LEAF_PICKUP
from minigrid_tpu_torch.envs.babyai.core.level import RoomGridLevel, action_instr, keep_where
from minigrid_tpu_torch.envs.babyai.open import door_colors


def random_color(generator, n: int, device) -> torch.Tensor:
    """int32 [N] uniform colors."""
    table = torch.tensor(SORTED_COLOR_IDX, dtype=torch.int32, device=device)
    return table[s_.randint(generator, n, 0, len(SORTED_COLOR_IDX), device).long()]


class Unlock(RoomGridLevel):
    """Unlock a door of a 3x3 maze (reference unlock.py:13-111)."""

    unblocking = True
    pool_factor = 3.5  # attempt validity 0.33

    def gen_attempt(self, generator, n, device):
        b = self.builder
        r, c = b.num_rows, b.num_cols
        s = b.init(generator, n, device)
        id_ = s_.randint(generator, n, 0, c, device)
        jd = s_.randint(generator, n, 0, r, device)
        s, door_color, _ = b.add_door(generator, s, id_, jd, None, locked=True)
        # The key in another room: uniform over the others.
        flat = (jd * c + id_ + s_.randint(generator, n, 1, r * c, device)) % (r * c)
        s, _, _, _ = b.add_object(generator, s, flat % c, flat // c, kind=OBJ_KEY, color=door_color)
        # Half the time the locked door is the only door of its color:
        # connect_all draws from the palette less that color (:83-88).
        only_color = s_.randint(generator, n, 0, 2, device) == 0
        s = b.connect_all(generator, s, exclude_color=torch.where(only_color, door_color, -1))
        # Three distractors in every room but the locked one.
        for i in range(c):
            for j in range(r):
                before = s
                for _ in range(3):
                    s, _, _, _ = b.add_object(generator, s, i, j)
                s = keep_where((id_ == i) & (jd == j), before, s)
        # The agent anywhere but the locked room.
        aflat = (jd * c + id_ + s_.randint(generator, n, 1, r * c, device)) % (r * c)
        s = b.place_agent(generator, s, aflat % c, aflat // c)
        valid = self.check_objs_reachable(s)
        return s, action_instr(b, s, LEAF_OPEN, OBJ_DOOR, door_color), valid


class UnlockLocal(RoomGridLevel):
    """Unlock the door of the agent's room (reference unlock.py:113-175)."""

    pool_factor = 1.0  # every attempt valid

    def __init__(self, distractors: bool = False, **kwargs):
        self.distractors = distractors
        super().__init__(**kwargs)

    def gen_attempt(self, generator, n, device):
        b = self.builder
        s = b.init(generator, n, device)
        s, door_color, _ = b.add_door(generator, s, 1, 1, None, locked=True)
        s, _, _, _ = b.add_object(generator, s, 1, 1, kind=OBJ_KEY, color=door_color)
        if self.distractors:
            s, _, _, _ = b.add_distractors(generator, s, i=1, j=1, num_distractors=3)
        s = b.place_agent(generator, s, 1, 1)
        valid = torch.ones(n, dtype=torch.bool, device=device)
        return s, action_instr(b, s, LEAF_OPEN, OBJ_DOOR), valid


class KeyInBox(RoomGridLevel):
    """Unlock a door whose key is hidden in a box (reference
    unlock.py:177-241).  The box holds a key of the locked door's color in
    the contents plane of every episode the level starts, reset cache
    included."""

    pool_factor = 1.0  # every attempt valid

    def gen_attempt(self, generator, n, device):
        b = self.builder
        s = b.init(generator, n, device)
        s, _, _ = b.add_door(generator, s, 1, 1, None, locked=True)
        box = cell(OBJ_BOX, random_color(generator, n, device))
        s, _ = b.place_in_room(generator, s, 1, 1, box)
        s = b.place_agent(generator, s, 1, 1)
        valid = torch.ones(n, dtype=torch.bool, device=device)
        return s, action_instr(b, s, LEAF_OPEN, OBJ_DOOR), valid

    def _finish_level(self, s, instr):
        state = super()._finish_level(s, instr)
        grid = state.grid
        # The door's color: that of the level's one locked door.
        locked = (cell_type(grid) == OBJ_DOOR) & (cell_state(grid) == STATE_LOCKED)
        door_color = torch.where(locked, cell_color(grid), 0).flatten(1).sum(dim=1, dtype=torch.int32)
        key = cell(OBJ_KEY, door_color)[:, None, None]
        return state.replace(contains=torch.where(cell_type(grid) == OBJ_BOX, key, state.contains))


class UnlockPickup(RoomGridLevel):
    """Unlock a door, then pick up the box of the other room (reference
    unlock.py:244-319)."""

    pool_factor = 1.0  # every attempt valid

    def __init__(self, distractors: bool = False, max_steps: int | None = None, **kwargs):
        self.distractors = distractors
        # The reference's `if max is None:` tests the builtin max, so its
        # 8*room_size**2 default never applies and the step limit stays
        # dynamic (reference unlock.py:301-309), as in the JAX package.
        super().__init__(num_rows=1, num_cols=2, room_size=6, max_steps=max_steps, **kwargs)

    def gen_attempt(self, generator, n, device):
        b = self.builder
        s = b.init(generator, n, device)
        s, _, box_color, _ = b.add_object(generator, s, 1, 0, kind=OBJ_BOX)
        s, door_color, _ = b.add_door(generator, s, 0, 0, 0, locked=True)
        s, _, _, _ = b.add_object(generator, s, 0, 0, kind=OBJ_KEY, color=door_color)
        if self.distractors:
            s, _, _, _ = b.add_distractors(generator, s, num_distractors=4)
        s = b.place_agent(generator, s, 0, 0)
        valid = torch.ones(n, dtype=torch.bool, device=device)
        return s, action_instr(b, s, LEAF_PICKUP, OBJ_BOX, box_color), valid


class BlockedUnlockPickup(RoomGridLevel):
    """UnlockPickup with a ball in front of the door (reference
    unlock.py:321-393)."""

    pool_factor = 1.0  # every attempt valid

    def __init__(self, max_steps: int | None = None, **kwargs):
        room_size = 6
        if max_steps is None:
            max_steps = 16 * room_size**2
        super().__init__(num_rows=1, num_cols=2, room_size=room_size, max_steps=max_steps, **kwargs)

    def gen_attempt(self, generator, n, device):
        b = self.builder
        s = b.init(generator, n, device)
        s, _, _, _ = b.add_object(generator, s, 1, 0, kind=OBJ_BOX)
        s, door_color, pos = b.add_door(generator, s, 0, 0, 0, locked=True)
        ball = cell(OBJ_BALL, random_color(generator, n, device))
        s = s.replace(grid=set_cell(s.grid, pos[:, 0] - 1, pos[:, 1], ball))
        s, _, _, _ = b.add_object(generator, s, 0, 0, kind=OBJ_KEY, color=door_color)
        s = b.place_agent(generator, s, 0, 0)
        valid = torch.ones(n, dtype=torch.bool, device=device)
        return s, action_instr(b, s, LEAF_PICKUP, OBJ_BOX), valid


class UnlockToUnlock(RoomGridLevel):
    """Two locked doors, the second's key behind the first (reference
    unlock.py:395-471)."""

    pool_factor = 1.0  # every attempt valid

    def __init__(self, max_steps: int | None = None, **kwargs):
        room_size = 6
        if max_steps is None:
            max_steps = 30 * room_size**2
        super().__init__(num_rows=1, num_cols=3, room_size=room_size, max_steps=max_steps, **kwargs)

    def gen_attempt(self, generator, n, device):
        b = self.builder
        s = b.init(generator, n, device)
        colors = door_colors(generator, n, 2, device)
        s, _, _ = b.add_door(generator, s, 0, 0, 0, color=colors[:, 0], locked=True)
        s, _, _, _ = b.add_object(generator, s, 2, 0, kind=OBJ_KEY, color=colors[:, 0])
        s, _, _ = b.add_door(generator, s, 1, 0, 0, color=colors[:, 1], locked=True)
        s, _, _, _ = b.add_object(generator, s, 1, 0, kind=OBJ_KEY, color=colors[:, 1])
        s, _, _, _ = b.add_object(generator, s, 0, 0, kind=OBJ_BALL)
        s = b.place_agent(generator, s, 1, 0)
        valid = torch.ones(n, dtype=torch.bool, device=device)
        return s, action_instr(b, s, LEAF_PICKUP, OBJ_BALL), valid
