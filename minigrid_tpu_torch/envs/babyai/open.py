"""BabyAI Open levels (reference: minigrid/envs/babyai/open.py).

Counterpart of ``minigrid_tpu/envs/babyai/open.py``: each level's
``gen_attempt`` builds N attempts at once from the caller's
``torch.Generator``.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import sampling as s_
from minigrid_tpu_torch.core.constants import COLOR_RED, COLOR_TO_IDX, OBJ_DOOR, SORTED_COLOR_IDX, cell_color, cell_type
from minigrid_tpu_torch.core.grid import get_cell
from minigrid_tpu_torch.envs.babyai.core.instr import (
    LEAF_NONE,
    LEAF_OPEN,
    TOP_ACTION,
    TOP_AFTER,
    TOP_BEFORE,
    empty_instr,
    set_desc,
    set_leaf,
    set_top,
)
from minigrid_tpu_torch.envs.babyai.core.level import RoomGridLevel, action_instr
from minigrid_tpu_torch.envs.gotoobject import permutation_prefix


def door_colors(generator, n: int, k: int, device) -> torch.Tensor:
    """int32 [N, k]: ``k`` distinct door colors, a uniform prefix of a
    permutation of the six."""
    table = torch.tensor(SORTED_COLOR_IDX, dtype=torch.int32, device=device)
    return table[permutation_prefix(generator, n, len(SORTED_COLOR_IDX), k, device)]


def _ordered_doors(builder, s, top, first_color, second_color, strict0: bool, strict2: bool, leaf2=LEAF_OPEN):
    """Open(first) in slot 0 and Open(second) in slot 2 under ``top``."""
    instr = empty_instr(s.grid.shape[0], builder.width, builder.height, s.grid.device)
    instr = set_leaf(set_top(instr, top), 0, LEAF_OPEN, strict=strict0)
    instr = set_leaf(instr, 2, leaf2, strict=strict2)
    room = builder.agent_room_mask(s)
    args = (s.grid, s.agent_pos, s.agent_dir, OBJ_DOOR)
    instr = set_desc(instr, 0, 0, *args, first_color, agent_room_mask=room)
    return set_desc(instr, 2, 0, *args, second_color, agent_room_mask=room)


class Open(RoomGridLevel):
    """Open a door in a 3x3 maze (reference open.py:18-86)."""

    pool_factor = 2.3  # attempt validity 0.51

    def gen_attempt(self, generator, n, device):
        b = self.builder
        s = b.init(generator, n, device)
        s = b.place_agent(generator, s)
        s = b.connect_all(generator, s)
        s, _, _, _ = b.add_distractors(generator, s, num_distractors=18, all_unique=False)
        valid = self.check_objs_reachable(s)
        # A uniform door cell: the reference lists each door once per room
        # it bounds (:74-85), and every door bounds two, so the marginal
        # over doors is the same.
        pos = s_.sample_mask_cell(generator, cell_type(s.grid) == OBJ_DOOR)
        color = cell_color(get_cell(s.grid, pos[:, 0], pos[:, 1]))
        return s, action_instr(b, s, LEAF_OPEN, OBJ_DOOR, color), valid


class OpenRedDoor(RoomGridLevel):
    """Open the red door of a two-room level (reference open.py:88-146)."""

    pool_factor = 1.0  # every attempt valid

    def __init__(self, **kwargs):
        super().__init__(num_rows=1, num_cols=2, room_size=5, **kwargs)

    def gen_attempt(self, generator, n, device):
        b = self.builder
        s = b.init(generator, n, device)
        s, _, _ = b.add_door(generator, s, 0, 0, 0, color=COLOR_RED, locked=False)
        s = b.place_agent(generator, s, 0, 0)
        valid = torch.ones(n, dtype=torch.bool, device=device)
        return s, action_instr(b, s, LEAF_OPEN, OBJ_DOOR, COLOR_RED), valid


class OpenDoor(RoomGridLevel):
    """Open a door named by its color or by its location (reference
    open.py:148-228); ``debug`` makes the leaf strict."""

    pool_factor = 1.0  # every attempt valid

    def __init__(self, debug: bool = False, select_by: str | None = None, **kwargs):
        self.select_by = select_by
        self.debug = debug
        super().__init__(**kwargs)

    def gen_attempt(self, generator, n, device):
        b = self.builder
        s = b.init(generator, n, device)
        colors = door_colors(generator, n, 4, device)
        for k in range(4):
            s, _, _ = b.add_door(generator, s, 1, 1, k, color=colors[:, k], locked=False)
        if self.select_by is None:
            by_color = s_.randint(generator, n, 0, 2, device) == 0
        else:
            by_color = torch.full((n,), self.select_by == "color", dtype=torch.bool, device=device)
        loc = s_.randint(generator, n, 0, 4, device)
        d_color = torch.where(by_color, colors[:, 0], -1)
        d_loc = torch.where(by_color, -1, loc)
        s = b.place_agent(generator, s, 1, 1)
        valid = torch.ones(n, dtype=torch.bool, device=device)
        return s, action_instr(b, s, LEAF_OPEN, OBJ_DOOR, d_color, d_loc, strict=self.debug), valid


class OpenTwoDoors(RoomGridLevel):
    """Open door A, then door B (reference open.py:231-323); ``strict``
    fails the first leaf on a wrong door."""

    pool_factor = 1.0  # every attempt valid

    def __init__(
        self,
        first_color: str | None = None,
        second_color: str | None = None,
        strict: bool = False,
        max_steps: int | None = None,
        **kwargs,
    ):
        self.first_color = COLOR_TO_IDX[first_color] if first_color else None
        self.second_color = COLOR_TO_IDX[second_color] if second_color else None
        self.strict = strict
        room_size = 6
        if max_steps is None:
            max_steps = 20 * room_size**2
        super().__init__(room_size=room_size, max_steps=max_steps, **kwargs)

    def gen_attempt(self, generator, n, device):
        b = self.builder
        s = b.init(generator, n, device)
        colors = door_colors(generator, n, 2, device)
        c1 = colors[:, 0] if self.first_color is None else self.first_color
        c2 = colors[:, 1] if self.second_color is None else self.second_color
        s, _, _ = b.add_door(generator, s, 1, 1, 2, color=c1, locked=False)
        s, _, _ = b.add_door(generator, s, 1, 1, 0, color=c2, locked=False)
        s = b.place_agent(generator, s, 1, 1)
        valid = torch.ones(n, dtype=torch.bool, device=device)
        return s, _ordered_doors(b, s, TOP_BEFORE, c1, c2, self.strict, False), valid


class OpenDoorsOrder(RoomGridLevel):
    """Open one door, or two in a given order (reference open.py:326-422):
    the top is an action, Before or After, uniformly; ``debug`` makes both
    leaves strict."""

    pool_factor = 1.0  # every attempt valid

    def __init__(self, num_doors: int, debug: bool = False, max_steps: int | None = None, **kwargs):
        if num_doors < 2:
            raise ValueError(f"OpenDoorsOrder needs at least 2 doors, got {num_doors}")
        self.num_doors = num_doors
        self.debug = debug
        room_size = 6
        if max_steps is None:
            max_steps = 20 * room_size**2
        super().__init__(room_size=room_size, max_steps=max_steps, **kwargs)

    def gen_attempt(self, generator, n, device):
        b = self.builder
        k = self.num_doors
        s = b.init(generator, n, device)
        colors = door_colors(generator, n, k, device)
        for i in range(k):
            s, _, _ = b.add_door(generator, s, 1, 1, color=colors[:, i], locked=False)
        s = b.place_agent(generator, s, 1, 1)
        # Two distinct doors (reference :410): a uniform ordered pair.
        rows = torch.arange(n, device=device)
        p1 = s_.randint(generator, n, 0, k, device).long()
        p2 = (p1 + s_.randint(generator, n, 1, k, device)) % k
        mode = s_.randint(generator, n, 0, 3, device)
        top = torch.where(mode == 0, TOP_ACTION, torch.where(mode == 1, TOP_BEFORE, TOP_AFTER))
        # Leaf 2 takes part only in modes 1 and 2.
        leaf2 = torch.where(mode == 0, LEAF_NONE, LEAF_OPEN)
        instr = _ordered_doors(b, s, top, colors[rows, p1], colors[rows, p2], self.debug, self.debug, leaf2)
        return s, instr, torch.ones(n, dtype=torch.bool, device=device)
