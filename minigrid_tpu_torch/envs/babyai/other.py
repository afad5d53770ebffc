"""BabyAI's other levels (reference: minigrid/envs/babyai/other.py).

Counterpart of ``minigrid_tpu/envs/babyai/other.py`` (BabyAI's KeyCorridor;
the classic one is ``envs/keycorridor.py``): each level's ``gen_attempt``
builds N attempts at once from the caller's ``torch.Generator``.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import sampling as s_
from minigrid_tpu_torch.core.constants import OBJ_BALL, OBJ_DOOR, OBJ_KEY, OBJECT_TO_IDX
from minigrid_tpu_torch.envs.babyai.core.instr import LEAF_GOTO, LEAF_OPEN, LEAF_PICKUP, TOP_BEFORE
from minigrid_tpu_torch.envs.babyai.core.level import RoomGridLevel, action_instr
from minigrid_tpu_torch.envs.babyai.goto import picked
from minigrid_tpu_torch.envs.babyai.putnext import putnext_instr, two_picks


class ActionObjDoor(RoomGridLevel):
    """Pick up, go to or open an object or door of the agent's room
    (reference other.py:18-105)."""

    pool_factor = 1.0  # every attempt valid

    def __init__(self, **kwargs):
        super().__init__(room_size=7, **kwargs)

    def gen_attempt(self, generator, n, device):
        b = self.builder
        s = b.init(generator, n, device)
        s, kinds, colors, _ = b.add_distractors(generator, s, i=1, j=1, num_distractors=5)
        door_colors = []
        for _ in range(4):
            s, color, _ = b.add_door(generator, s, 1, 1, locked=False)
            door_colors.append(color)
        s = b.place_agent(generator, s, 1, 1)
        all_kinds = torch.cat([kinds, torch.full((n, 4), OBJ_DOOR, dtype=torch.int32, device=device)], dim=1)
        all_colors = torch.cat([colors, torch.stack(door_colors, dim=1)], dim=1)
        kind, pick = picked(generator, all_kinds, 9)
        color = all_colors[torch.arange(n, device=device), pick]
        # A door is gone to or opened, an object gone to or picked up
        # (reference :96-105).
        coin = s_.randint(generator, n, 0, 2, device) == 0
        leaf = torch.where(coin, LEAF_GOTO, torch.where(kind == OBJ_DOOR, LEAF_OPEN, LEAF_PICKUP))
        valid = torch.ones(n, dtype=torch.bool, device=device)
        return s, action_instr(b, s, leaf, kind, color), valid


class FindObjS5(RoomGridLevel):
    """Pick up an object named by its type alone, in any room (reference
    other.py:108-177)."""

    pool_factor = 1.0  # every attempt valid

    def __init__(self, room_size: int = 5, max_steps: int | None = None, **kwargs):
        if max_steps is None:
            max_steps = 20 * room_size**2
        super().__init__(room_size=room_size, max_steps=max_steps, **kwargs)

    def gen_attempt(self, generator, n, device):
        b = self.builder
        s = b.init(generator, n, device)
        # The reference draws i from num_rows and j from num_cols
        # (other.py:170-171); the lattice is 3x3, so that is the same.
        i = s_.randint(generator, n, 0, b.num_cols, device)
        j = s_.randint(generator, n, 0, b.num_rows, device)
        s, kind, _, _ = b.add_object(generator, s, i, j)
        s = b.place_agent(generator, s, 1, 1)
        s = b.connect_all(generator, s)
        valid = torch.ones(n, dtype=torch.bool, device=device)
        return s, action_instr(b, s, LEAF_PICKUP, kind), valid


class KeyCorridor(RoomGridLevel):
    """BabyAI's key corridor, a pickup named by type alone (reference
    other.py:179-272)."""

    pool_factor = 1.0  # every attempt valid

    def __init__(self, num_rows: int = 3, obj_type: str = "ball", room_size: int = 6, max_steps: int | None = None, **kwargs):
        self.obj_kind = OBJECT_TO_IDX[obj_type]
        if max_steps is None:
            max_steps = 30 * room_size**2
        super().__init__(room_size=room_size, num_rows=num_rows, num_cols=3, max_steps=max_steps, **kwargs)

    def gen_attempt(self, generator, n, device):
        b = self.builder
        s = b.init(generator, n, device)
        for j in range(1, b.num_rows):
            s = b.remove_wall(s, 1, j, 3)
        room = s_.randint(generator, n, 0, b.num_rows, device)
        s, door_color, _ = b.add_door(generator, s, 2, room, 2, locked=True)
        s, kind, _, _ = b.add_object(generator, s, 2, room, kind=self.obj_kind)
        key_room = s_.randint(generator, n, 0, b.num_rows, device)
        s, _, _, _ = b.add_object(generator, s, 0, key_room, kind=OBJ_KEY, color=door_color)
        s = b.place_agent(generator, s, 1, b.num_rows // 2)
        s = b.connect_all(generator, s)
        valid = torch.ones(n, dtype=torch.bool, device=device)
        return s, action_instr(b, s, LEAF_PICKUP, kind), valid


class OneRoomS8(RoomGridLevel):
    """Pick up the ball of a single room (reference other.py:274-332)."""

    pool_factor = 1.0  # every attempt valid

    def __init__(self, room_size: int = 8, **kwargs):
        super().__init__(room_size=room_size, num_rows=1, num_cols=1, **kwargs)

    def gen_attempt(self, generator, n, device):
        b = self.builder
        s = b.init(generator, n, device)
        s, kind, _, _ = b.add_object(generator, s, 0, 0, kind=OBJ_BALL)
        s = b.place_agent(generator, s)
        valid = torch.ones(n, dtype=torch.bool, device=device)
        return s, action_instr(b, s, LEAF_PICKUP, kind), valid


class MoveTwoAcross(RoomGridLevel):
    """Two PutNext tasks across two rooms, in order (reference
    other.py:334-425)."""

    pool_factor = 1.0  # every attempt valid

    def __init__(self, room_size: int, objs_per_room: int, max_steps: int | None = None, **kwargs):
        if objs_per_room > 9:
            raise ValueError(f"MoveTwoAcross needs objs_per_room <= 9, got {objs_per_room}")
        self.objs_per_room = objs_per_room
        if max_steps is None:
            max_steps = 16 * room_size**2
        super().__init__(num_rows=1, num_cols=2, room_size=room_size, max_steps=max_steps, **kwargs)

    def gen_attempt(self, generator, n, device):
        b = self.builder
        k = self.objs_per_room
        s = b.init(generator, n, device)
        s = b.place_agent(generator, s, 0, 0)
        s, kl, cl, _ = b.add_distractors(generator, s, i=0, j=0, num_distractors=k)
        s, kr, cr, _ = b.add_distractors(generator, s, i=1, j=0, num_distractors=k)
        s = b.remove_wall(s, 0, 0, 0)
        # Two distinct objects of each room (reference :414-419).
        rows = torch.arange(n, device=device)
        la, lb = two_picks(generator, n, k, device)
        ra, rb = two_picks(generator, n, k, device)
        leaves = {
            0: (kl[rows, la], cl[rows, la], kr[rows, ra], cr[rows, ra]),
            2: (kr[rows, rb], cr[rows, rb], kl[rows, lb], cl[rows, lb]),
        }
        return s, putnext_instr(b, s, TOP_BEFORE, leaves), torch.ones(n, dtype=torch.bool, device=device)
