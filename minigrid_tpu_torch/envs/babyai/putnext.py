"""BabyAI PutNext levels (reference: minigrid/envs/babyai/putnext.py).

Counterpart of ``minigrid_tpu/envs/babyai/putnext.py``: each level's
``gen_attempt`` builds N attempts at once from the caller's
``torch.Generator``.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import sampling as s_
from minigrid_tpu_torch.core.constants import EMPTY_CELL, pack_carry
from minigrid_tpu_torch.core.grid import set_cell
from minigrid_tpu_torch.envs.babyai.core.instr import (
    LEAF_PUTNEXT,
    TOP_ACTION,
    empty_instr,
    set_desc,
    set_leaf,
    set_top,
    start_carrying_object,
    tracked_plane,
)
from minigrid_tpu_torch.envs.babyai.core.level import RoomGridLevel


def putnext_instr(builder, s, top, leaves):
    """PutNext leaves under ``top``: ``leaves`` maps a slot to its (move
    type, move color, fixed type, fixed color), resolved in the agent's
    start room."""
    instr = set_top(empty_instr(s.grid.shape[0], builder.width, builder.height, s.grid.device), top)
    room = builder.agent_room_mask(s)
    for leaf, (m_type, m_color, f_type, f_color) in leaves.items():
        instr = set_leaf(instr, leaf, LEAF_PUTNEXT)
        instr = set_desc(instr, leaf, 0, s.grid, s.agent_pos, s.agent_dir, m_type, m_color, agent_room_mask=room)
        instr = set_desc(instr, leaf, 1, s.grid, s.agent_pos, s.agent_dir, f_type, f_color, agent_room_mask=room)
    return instr


def two_picks(generator, n: int, count: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Two distinct uniform indices below ``count`` per env (the same one
    where ``count`` is 1), int64 [N] each."""
    first = s_.randint(generator, n, 0, count, device).long()
    if count == 1:
        return first, first
    return first, (first + s_.randint(generator, n, 1, count, device)) % count


class PutNextLocal(RoomGridLevel):
    """Put an object next to another in a single room (reference
    putnext.py:11-80)."""

    pool_factor = 1.9  # attempt validity 0.60 (PutNextLocalS5N3) to 0.77

    def __init__(self, room_size: int = 8, num_objs: int = 8, **kwargs):
        self.num_objs = num_objs
        super().__init__(num_rows=1, num_cols=1, room_size=room_size, **kwargs)

    def gen_attempt(self, generator, n, device):
        b = self.builder
        s = b.init(generator, n, device)
        s = b.place_agent(generator, s, 0, 0)
        s, kinds, colors, _ = b.add_distractors(generator, s, num_distractors=self.num_objs, all_unique=True)
        valid = self.check_objs_reachable(s)
        rows = torch.arange(n, device=device)
        p1, p2 = two_picks(generator, n, self.num_objs, device)
        leaf = (kinds[rows, p1], colors[rows, p1], kinds[rows, p2], colors[rows, p2])
        return s, putnext_instr(b, s, TOP_ACTION, {0: leaf}), valid


class PutNext(RoomGridLevel):
    """Put an object of one room next to an object of the other (reference
    putnext.py:82-201); with ``start_carrying`` the agent starts with the
    object to move in hand."""

    pool_factor = 1.0  # every attempt valid

    def __init__(self, room_size: int, objs_per_room: int, start_carrying: bool = False, max_steps: int | None = None, **kwargs):
        if room_size < 4 or objs_per_room > 9:
            raise ValueError(f"PutNext needs room_size >= 4 and objs_per_room <= 9, got {room_size}, {objs_per_room}")
        self.objs_per_room = objs_per_room
        self.start_carrying = start_carrying
        if max_steps is None:
            max_steps = 8 * room_size**2
        super().__init__(num_rows=1, num_cols=2, room_size=room_size, max_steps=max_steps, **kwargs)

    def gen_attempt(self, generator, n, device):
        b = self.builder
        k = self.objs_per_room
        s = b.init(generator, n, device)
        s = b.place_agent(generator, s, 0, 0)
        s, kl, cl, _ = b.add_distractors(generator, s, i=0, j=0, num_distractors=k)
        s, kr, cr, _ = b.add_distractors(generator, s, i=1, j=0, num_distractors=k)
        s = b.remove_wall(s, 0, 0, 0)
        rows = torch.arange(n, device=device)
        ia = s_.randint(generator, n, 0, k, device).long()
        ib = s_.randint(generator, n, 0, k, device).long()
        # The object to move is in the left room or, half the time, the right.
        flip = (s_.randint(generator, n, 0, 2, device) == 0)[:, None]
        left = torch.stack([kl[rows, ia], cl[rows, ia]], dim=1)
        right = torch.stack([kr[rows, ib], cr[rows, ib]], dim=1)
        move, fixed = torch.where(flip, right, left), torch.where(flip, left, right)
        instr = putnext_instr(b, s, TOP_ACTION, {0: (move[:, 0], move[:, 1], fixed[:, 0], fixed[:, 1])})
        return s, instr, torch.ones(n, dtype=torch.bool, device=device)

    def _finish_level(self, s, instr):
        if not self.start_carrying:
            return super()._finish_level(s, instr)
        # The move object lifted into the agent's hand after validation, as
        # the reference's reset does (:190-200); every object of the level
        # is unique, so the move descriptor tracks that one cell.  The
        # carried object is the descriptor's (type, color), in every
        # episode the level starts, reset cache included.
        n, _, h = s.grid.shape
        idx = tracked_plane(instr.gridm, 0, 0).reshape(n, -1).to(torch.uint8).argmax(dim=1)
        pos = torch.stack([idx // h, idx % h], dim=1)
        instr = start_carrying_object(instr, pos)
        s = s.replace(grid=set_cell(s.grid, pos[:, 0], pos[:, 1], EMPTY_CELL))
        state = super()._finish_level(s, instr)
        return state.replace(carrying=pack_carry(instr.d_type[:, 0, 0], instr.d_color[:, 0, 0]).int())
