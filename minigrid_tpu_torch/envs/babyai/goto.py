"""BabyAI GoTo levels (reference: minigrid/envs/babyai/goto.py).

Counterpart of ``minigrid_tpu/envs/babyai/goto.py``: each level's
``gen_attempt`` builds N attempts at once from the caller's
``torch.Generator``.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import sampling as s_
from minigrid_tpu_torch.core.constants import COLOR_BLUE, COLOR_GREY, COLOR_RED, OBJ_BALL, OBJ_DOOR, OBJ_KEY
from minigrid_tpu_torch.core.grid import cell_mask
from minigrid_tpu_torch.envs.babyai.core.instr import LEAF_GOTO, TOP_ACTION, empty_instr, set_desc, set_leaf, set_top
from minigrid_tpu_torch.envs.babyai.core.level import RoomGridLevel, keep_where


def _single_goto(builder, s, d_type, d_color=-1):
    """GoToInstr(ObjDesc(type, color)) on the finished grid of ``s``."""
    instr = empty_instr(s.grid.shape[0], builder.width, builder.height, s.grid.device)
    instr = set_leaf(set_top(instr, TOP_ACTION), 0, LEAF_GOTO)
    return set_desc(instr, 0, 0, s.grid, s.agent_pos, s.agent_dir, d_type, d_color)


def picked(generator, values: torch.Tensor, count: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A uniform column of ``values`` [N, count] per env, and its index."""
    n = values.shape[0]
    pick = s_.randint(generator, n, 0, count, values.device).long()
    return values[torch.arange(n, device=values.device), pick], pick


class GoToRedBallGrey(RoomGridLevel):
    """Go to the red ball; every distractor is grey (reference goto.py:62-77)."""

    pool_factor = 1.3  # attempt validity ~0.85

    def __init__(self, room_size: int = 8, num_dists: int = 7, **kwargs):
        self.num_dists = num_dists
        super().__init__(room_size=room_size, num_rows=1, num_cols=1, **kwargs)

    def gen_attempt(self, generator, n, device):
        b = self.builder
        s = b.init(generator, n, device)
        s = b.place_agent(generator, s, 0, 0)
        s, _, _, _ = b.add_object(generator, s, 0, 0, kind=OBJ_BALL, color=COLOR_RED)
        s, _, _, positions = b.add_distractors(generator, s, num_distractors=self.num_dists, all_unique=False)
        # The distractors recoloured grey (reference :71-72).
        grid = s.grid
        for d in range(self.num_dists):
            m = cell_mask(grid, positions[:, d, 0], positions[:, d, 1])
            grid = torch.where(m, (grid & ~0xFF00) | (COLOR_GREY << 8), grid)
        s = s.replace(grid=grid)
        return s, _single_goto(b, s, OBJ_BALL, COLOR_RED), self.check_objs_reachable(s)


class GoToRedBall(RoomGridLevel):
    """Go to the red ball among coloured distractors (reference goto.py:128-140)."""

    pool_factor = 1.3  # attempt validity ~0.85

    def __init__(self, room_size: int = 8, num_dists: int = 7, **kwargs):
        self.num_dists = num_dists
        super().__init__(room_size=room_size, num_rows=1, num_cols=1, **kwargs)

    def gen_attempt(self, generator, n, device):
        b = self.builder
        s = b.init(generator, n, device)
        s = b.place_agent(generator, s, 0, 0)
        s, _, _, _ = b.add_object(generator, s, 0, 0, kind=OBJ_BALL, color=COLOR_RED)
        s, _, _, _ = b.add_distractors(generator, s, num_distractors=self.num_dists, all_unique=False)
        return s, _single_goto(b, s, OBJ_BALL, COLOR_RED), self.check_objs_reachable(s)


class GoToRedBallNoDists(GoToRedBall):
    """(reference goto.py:143-192)"""

    def __init__(self, **kwargs):
        super().__init__(room_size=8, num_dists=0, **kwargs)


class GoToObj(RoomGridLevel):
    """Go to the single object in the room (reference goto.py:195-259)."""

    def __init__(self, room_size: int = 8, **kwargs):
        super().__init__(room_size=room_size, num_rows=1, num_cols=1, **kwargs)

    def gen_attempt(self, generator, n, device):
        b = self.builder
        s = b.init(generator, n, device)
        s = b.place_agent(generator, s, 0, 0)
        s, kinds, colors, _ = b.add_distractors(generator, s, num_distractors=1)
        valid = torch.ones(n, dtype=torch.bool, device=device)
        return s, _single_goto(b, s, kinds[:, 0], colors[:, 0]), valid


class GoToLocal(RoomGridLevel):
    """Go to a named object in a single room (reference goto.py:262-337)."""

    pool_factor = 1.3  # attempt validity ~0.84

    def __init__(self, room_size: int = 8, num_dists: int = 8, **kwargs):
        self.num_dists = num_dists
        super().__init__(room_size=room_size, num_rows=1, num_cols=1, **kwargs)

    def gen_attempt(self, generator, n, device):
        b = self.builder
        s = b.init(generator, n, device)
        s = b.place_agent(generator, s, 0, 0)
        s, kinds, colors, _ = b.add_distractors(generator, s, num_distractors=self.num_dists, all_unique=False)
        valid = self.check_objs_reachable(s)
        kind, pick = picked(generator, kinds, self.num_dists)
        color = colors[torch.arange(n, device=device), pick]
        return s, _single_goto(b, s, kind, color), valid


class GoTo(RoomGridLevel):
    """Go to a named object in a 3x3 maze (reference goto.py:340-426)."""

    def __init__(
        self, room_size: int = 8, num_rows: int = 3, num_cols: int = 3, num_dists: int = 18, doors_open: bool = False, **kwargs
    ):
        self.num_dists = num_dists
        self.doors_open = doors_open
        super().__init__(room_size=room_size, num_rows=num_rows, num_cols=num_cols, **kwargs)

    def gen_attempt(self, generator, n, device):
        b = self.builder
        s = b.init(generator, n, device)
        s = b.place_agent(generator, s)
        s = b.connect_all(generator, s)
        s, kinds, colors, _ = b.add_distractors(generator, s, num_distractors=self.num_dists, all_unique=False)
        valid = self.check_objs_reachable(s)
        kind, pick = picked(generator, kinds, self.num_dists)
        instr = _single_goto(b, s, kind, colors[torch.arange(n, device=device), pick])
        if self.doors_open:
            # The descriptors were resolved with the doors closed; opening
            # changes a door's state, not what it is, so the masks hold.
            s = b.open_all_doors(s)
        return s, instr, valid


class GoToImpUnlock(RoomGridLevel):
    """Go to an object, possibly behind a locked door; unlocking is implicit
    (reference goto.py:428-524)."""

    def gen_attempt(self, generator, n, device):
        b = self.builder
        r, c = b.num_rows, b.num_cols
        id_ = s_.randint(generator, n, 0, c, device)
        jd = s_.randint(generator, n, 0, r, device)
        s = b.init(generator, n, device)
        s, door_color, _ = b.add_door(generator, s, id_, jd, None, locked=True)
        # The key in another room (reference :489-496): uniform over the others.
        flat = (jd * c + id_ + s_.randint(generator, n, 1, r * c, device)) % (r * c)
        s, _, _, _ = b.add_object(generator, s, flat % c, flat // c, kind=OBJ_KEY, color=door_color)
        s = b.connect_all(generator, s)
        # Two distractors in every room but the locked one (:503-508).
        for i in range(c):
            for j in range(r):
                before = s
                s, _, _, _ = b.add_object(generator, s, i, j)
                s, _, _, _ = b.add_object(generator, s, i, j)
                s = keep_where((id_ == i) & (jd == j), before, s)
        # The agent anywhere but the locked room (:511-518).
        aflat = (jd * c + id_ + s_.randint(generator, n, 1, r * c, device)) % (r * c)
        s = b.place_agent(generator, s, aflat % c, aflat // c)
        valid = self.check_objs_reachable(s)
        # The single object in the locked room is the target (:522-524).
        s, kind, color, _ = b.add_object(generator, s, id_, jd)
        return s, _single_goto(b, s, kind, color), valid


class GoToRedBlueBall(RoomGridLevel):
    """Go to the red or the blue ball, the only one in the room (reference
    goto.py:603-676)."""

    def __init__(self, room_size: int = 8, num_dists: int = 7, **kwargs):
        self.num_dists = num_dists
        super().__init__(room_size=room_size, num_rows=1, num_cols=1, **kwargs)

    def gen_attempt(self, generator, n, device):
        b = self.builder
        s = b.init(generator, n, device)
        s = b.place_agent(generator, s, 0, 0)
        s, kinds, colors, _ = b.add_distractors(generator, s, num_distractors=self.num_dists, all_unique=False)
        # No red or blue ball among the distractors (reference :666-668).
        bad = ((kinds == OBJ_BALL) & ((colors == COLOR_RED) | (colors == COLOR_BLUE))).any(dim=1)
        color = torch.where(s_.randint(generator, n, 0, 2, device) == 0, COLOR_RED, COLOR_BLUE).int()
        s, _, _, _ = b.add_object(generator, s, 0, 0, kind=OBJ_BALL, color=color)
        valid = ~bad & self.check_objs_reachable(s)
        return s, _single_goto(b, s, OBJ_BALL, color), valid


class GoToDoor(RoomGridLevel):
    """Go to a door of the centre room (reference goto.py:679-760)."""

    def __init__(self, **kwargs):
        super().__init__(room_size=7, **kwargs)

    def gen_attempt(self, generator, n, device):
        b = self.builder
        s = b.init(generator, n, device)
        colors = []
        for _ in range(4):
            s, color, _ = b.add_door(generator, s, 1, 1)
            colors.append(color)
        s = b.place_agent(generator, s, 1, 1)
        target, _ = picked(generator, torch.stack(colors, dim=1), 4)
        valid = torch.ones(n, dtype=torch.bool, device=device)
        return s, _single_goto(b, s, OBJ_DOOR, target), valid


class GoToObjDoor(RoomGridLevel):
    """Go to an object or a door of the centre room (reference
    goto.py:762-814)."""

    def __init__(self, **kwargs):
        super().__init__(room_size=8, **kwargs)

    def gen_attempt(self, generator, n, device):
        b = self.builder
        s = b.init(generator, n, device)
        s = b.place_agent(generator, s, 1, 1)
        s, kinds, colors, _ = b.add_distractors(generator, s, i=1, j=1, num_distractors=8, all_unique=False)
        door_colors = []
        for _ in range(4):
            s, color, _ = b.add_door(generator, s, 1, 1)
            door_colors.append(color)
        valid = self.check_objs_reachable(s)
        all_kinds = torch.cat([kinds, torch.full((n, 4), OBJ_DOOR, dtype=torch.int32, device=device)], dim=1)
        all_colors = torch.cat([colors, torch.stack(door_colors, dim=1)], dim=1)
        kind, pick = picked(generator, all_kinds, 12)
        color = all_colors[torch.arange(n, device=device), pick]
        return s, _single_goto(b, s, kind, color), valid
