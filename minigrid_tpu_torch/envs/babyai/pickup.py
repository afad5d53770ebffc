"""BabyAI Pickup levels (reference: minigrid/envs/babyai/pickup.py).

Counterpart of ``minigrid_tpu/envs/babyai/pickup.py``: each level's
``gen_attempt`` builds N attempts at once from the caller's
``torch.Generator``.  PickupLoc is a LevelGen (``levelgen.py``).
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import sampling as s_
from minigrid_tpu_torch.envs.babyai.core.instr import LEAF_PICKUP
from minigrid_tpu_torch.envs.babyai.core.level import RoomGridLevel, action_instr
from minigrid_tpu_torch.envs.babyai.goto import picked


class Pickup(RoomGridLevel):
    """Pick up a named object in a 3x3 maze (reference pickup.py:12-72)."""

    pool_factor = 2.3  # attempt validity 0.51

    def gen_attempt(self, generator, n, device):
        b = self.builder
        s = b.init(generator, n, device)
        s = b.place_agent(generator, s)
        s = b.connect_all(generator, s)
        s, kinds, colors, _ = b.add_distractors(generator, s, num_distractors=18, all_unique=False)
        valid = self.check_objs_reachable(s)
        kind, pick = picked(generator, kinds, 18)
        color = colors[torch.arange(n, device=device), pick]
        return s, action_instr(b, s, LEAF_PICKUP, kind, color), valid


class UnblockPickup(RoomGridLevel):
    """Pick up a named object that something may block (reference
    pickup.py:74-140)."""

    unblocking = True
    pool_factor = 2.2  # attempt validity 0.53

    def gen_attempt(self, generator, n, device):
        b = self.builder
        s = b.init(generator, n, device)
        s = b.place_agent(generator, s)
        s = b.connect_all(generator, s)
        s, kinds, colors, _ = b.add_distractors(generator, s, num_distractors=20, all_unique=False)
        # Some object must be out of reach (reference :134-136).
        valid = ~self.check_objs_reachable(s)
        kind, pick = picked(generator, kinds, 20)
        color = colors[torch.arange(n, device=device), pick]
        return s, action_instr(b, s, LEAF_PICKUP, kind, color), valid


class PickupDist(RoomGridLevel):
    """Pick up an object named by its type, its color or both (reference
    pickup.py:214-289); ``debug`` makes the leaf strict."""

    pool_factor = 1.0  # every attempt valid

    def __init__(self, debug: bool = False, **kwargs):
        self.debug = debug
        super().__init__(num_rows=1, num_cols=1, room_size=7, **kwargs)

    def gen_attempt(self, generator, n, device):
        b = self.builder
        s = b.init(generator, n, device)
        s, kinds, colors, _ = b.add_distractors(generator, s, num_distractors=5)
        s = b.place_agent(generator, s, 0, 0)
        kind, pick = picked(generator, kinds, 5)
        color = colors[torch.arange(n, device=device), pick]
        select = s_.randint(generator, n, 0, 3, device)  # 0 type, 1 color, 2 both
        d_type = torch.where(select == 1, -1, kind)
        d_color = torch.where(select == 0, -1, color)
        valid = torch.ones(n, dtype=torch.bool, device=device)
        return s, action_instr(b, s, LEAF_PICKUP, d_type, d_color, strict=self.debug), valid


class PickupAbove(RoomGridLevel):
    """Pick up an object in the room above (reference pickup.py:292-361)."""

    pool_factor = 1.0  # every attempt valid

    def __init__(self, max_steps: int | None = None, **kwargs):
        room_size = 6
        if max_steps is None:
            max_steps = 8 * room_size**2
        super().__init__(room_size=room_size, max_steps=max_steps, **kwargs)

    def gen_attempt(self, generator, n, device):
        b = self.builder
        s = b.init(generator, n, device)
        s, kind, color, _ = b.add_object(generator, s, 1, 0)
        s, _, _ = b.add_door(generator, s, 1, 1, 3, locked=False)
        s = b.place_agent(generator, s, 1, 1)
        s = b.connect_all(generator, s)
        valid = torch.ones(n, dtype=torch.bool, device=device)
        return s, action_instr(b, s, LEAF_PICKUP, kind, color), valid
