"""BabyAI LevelGen and its Synth and Boss levels (reference:
minigrid/envs/babyai/core/levelgen.py, minigrid/envs/babyai/synth.py).

Counterpart of ``minigrid_tpu/envs/babyai/levelgen.py``: ``gen_attempt``
builds N attempts at once from the caller's ``torch.Generator``.  Every
attempt draws its instruction's shape (an action, an And, or a Before or
After of actions and Ands), the kind of each of its four leaves and two
descriptors a leaf, so the shapes differ from env to env.  A descriptor is
redrawn until it names an object (``_rand_obj``, at most 100 redraws as in
the JAX package), and only the envs whose descriptor names nothing yet draw
again.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import sampling as s_
from minigrid_tpu_torch.core.constants import OBJ_BALL, OBJ_BOX, OBJ_DOOR, OBJ_KEY, SORTED_COLOR_IDX
from minigrid_tpu_torch.envs.babyai.core.instr import (
    LEAF_GOTO,
    LEAF_NONE,
    LEAF_OPEN,
    LEAF_PICKUP,
    LEAF_PUTNEXT,
    TOP_ACTION,
    TOP_AFTER,
    TOP_AND,
    TOP_BEFORE,
    desc_match_mask,
    empty_instr,
    set_desc,
    set_top,
)
from minigrid_tpu_torch.envs.babyai.core.level import RoomGridLevel, keep_where

# Types in the reference's draw order OBJ_TYPES = [box, ball, key, door]
# (verifier.py:15-18).
_TYPES = (OBJ_BOX, OBJ_BALL, OBJ_KEY, OBJ_DOOR)
_ACTION_TO_LEAF = {"goto": LEAF_GOTO, "pickup": LEAF_PICKUP, "open": LEAF_OPEN, "putnext": LEAF_PUTNEXT}
# Descriptor type modes: all four types, no door, door only.
_ALL_TYPES, _NO_DOOR, _DOOR_ONLY = 0, 1, 2
# Redraws of a descriptor that names no object (the JAX package's bound).
_DESC_REDRAWS = 100


class LevelGen(RoomGridLevel):
    """Levels of random instructions (reference levelgen.py:24-210)."""

    pool_factor = 1.4  # attempt validity 0.85 (BossLevel)

    def __init__(
        self,
        room_size: int = 8,
        num_rows: int = 3,
        num_cols: int = 3,
        num_dists: int = 18,
        locked_room_prob: float = 0.5,
        locations: bool = True,
        unblocking: bool = True,
        implicit_unlock: bool = True,
        action_kinds=("goto", "pickup", "open", "putnext"),
        instr_kinds=("action", "and", "seq"),
        **kwargs,
    ):
        self.num_dists = num_dists
        self.locked_room_prob = float(locked_room_prob)
        self.locations = bool(locations)
        # Read by _validate too (no key of a locked door's color named).
        self.unblocking = bool(unblocking)
        self.implicit_unlock = bool(implicit_unlock)
        self.action_kinds = tuple(action_kinds)
        self.instr_kinds = tuple(instr_kinds)
        super().__init__(room_size=room_size, num_rows=num_rows, num_cols=num_cols, **kwargs)

    # -- components ---------------------------------------------------------------
    def _add_locked_room(self, generator, s):
        """A locked door on a random wall of a random room, its key in
        another room (reference levelgen.py:85-112).  Returns (state, the
        room's flat index int32 [N], its rectangle bool [N, W, H])."""
        b = self.builder
        r, c = b.num_rows, b.num_cols
        n, device = s.grid.shape[0], s.grid.device
        i = s_.randint(generator, n, 0, c, device)
        j = s_.randint(generator, n, 0, r, device)
        wall = b.random_free_wall(generator, s, i, j)
        s, door_color, _ = b.add_door(generator, s, i, j, wall, locked=True)
        flat = j * c + i
        key = (flat + s_.randint(generator, n, 1, max(r * c, 2), device)) % (r * c)
        s, _, _, _ = b.add_object(generator, s, key % c, key // c, kind=OBJ_KEY, color=door_color)
        return s, flat, b.room_interior_mask(i, j)

    def _desc_attempt(self, generator, grid, agent_pos, agent_dir, room_mask, mode, locked_rect, have_locked):
        """One descriptor draw per env: (type, color, loc, names an object),
        int32 [N] and bool [N] (reference levelgen.py:114-155)."""
        n, device = grid.shape[0], grid.device
        colors = torch.tensor(SORTED_COLOR_IDX, dtype=torch.int32, device=device)
        types = torch.tensor(_TYPES, dtype=torch.int32, device=device)
        # Seven color outcomes: none, or one of the six.
        draw = s_.randint(generator, n, 0, len(SORTED_COLOR_IDX) + 1, device).long()
        color = torch.where(draw == 0, -1, colors[(draw - 1).clamp(min=0)])
        ntypes = torch.where(mode == _ALL_TYPES, 4, torch.where(mode == _NO_DOOR, 3, 1)).int()
        typ = torch.where(mode == _DOOR_ONLY, OBJ_DOOR, types[s_.randint(generator, n, 0, ntypes).long()])
        if self.locations:
            use_loc = s_.randint(generator, n, 0, 2, device) == 0
            loc = torch.where(use_loc, s_.randint(generator, n, 0, 4, device), -1)
        else:
            loc = torch.full((n,), -1, dtype=torch.int32, device=device)
        mask = desc_match_mask(grid, typ, color, loc, agent_pos, agent_dir, room_mask)
        ok = mask.flatten(1).any(dim=1)
        if not self.implicit_unlock:
            # A match outside the locked room too (:120-122).
            ok &= ~have_locked | (mask & ~locked_rect).flatten(1).any(dim=1)
        return typ.int(), color.int(), loc.int(), ok

    def _rand_obj(self, generator, s, room_mask, mode, locked_rect, have_locked):
        """A descriptor per env that names at least one object, drawn again
        up to 100 times, each time for the envs whose draw named none.
        Returns (type, color, loc, ok): an env still without a match keeps
        its last draw with ``ok`` False, which rejects its attempt."""
        args = (s.grid, s.agent_pos, s.agent_dir, room_mask, mode, locked_rect, have_locked)
        typ, color, loc, ok = self._desc_attempt(generator, *args)
        for _ in range(_DESC_REDRAWS):
            redo = torch.nonzero(~ok, as_tuple=True)[0]
            if redo.numel() == 0:
                break
            t2, c2, l2, ok2 = self._desc_attempt(generator, *(a[redo] for a in args))
            typ, color, loc, ok = (v.index_copy(0, redo, w) for v, w in ((typ, t2), (color, c2), (loc, l2), (ok, ok2)))
        return typ, color, loc, ok

    # -- generation -------------------------------------------------------------------
    def gen_attempt(self, generator, n, device):
        b = self.builder
        r, c = b.num_rows, b.num_cols
        s = b.init(generator, n, device)
        have_locked = torch.rand(n, generator=generator, device=device) < self.locked_room_prob
        if self.locked_room_prob > 0:
            with_room, locked_flat, locked_rect = self._add_locked_room(generator, s)
            s = keep_where(have_locked, with_room, s)
            locked_rect = locked_rect & have_locked[:, None, None]
        else:
            locked_flat = torch.zeros(n, dtype=torch.int32, device=device)
            locked_rect = torch.zeros((n, b.width, b.height), dtype=torch.bool, device=device)
        s = b.connect_all(generator, s)
        s, _, _, _ = b.add_distractors(generator, s, num_distractors=self.num_dists, all_unique=False)
        # The agent anywhere but the locked room (reference levelgen.py:67-73).
        beside_locked = (locked_flat + s_.randint(generator, n, 1, max(r * c, 2), device)) % (r * c)
        anywhere = s_.randint(generator, n, 0, r * c, device)
        room = torch.where(have_locked, beside_locked, anywhere)
        s = b.place_agent(generator, s, room % c, room // c)
        valid = torch.ones(n, dtype=torch.bool, device=device)
        if not self.unblocking:
            valid &= self.check_objs_reachable(s)

        # The instruction's shape (reference rand_instr, levelgen.py:157-210).
        shape = s_.randint(generator, n, 0, len(self.instr_kinds), device)
        is_kind = {name: torch.zeros(n, dtype=torch.bool, device=device) for name in ("action", "and", "seq")}
        for k, name in enumerate(self.instr_kinds):
            is_kind[name] |= shape == k
        is_and, is_seq = is_kind["and"], is_kind["seq"]
        a_is_and = is_seq & (s_.randint(generator, n, 0, 2, device) == 1)
        b_is_and = is_seq & (s_.randint(generator, n, 0, 2, device) == 1)
        before = s_.randint(generator, n, 0, 2, device) == 0
        top = torch.where(
            is_kind["action"], TOP_ACTION, torch.where(is_and, TOP_AND, torch.where(before, TOP_BEFORE, TOP_AFTER))
        )
        active = (torch.ones_like(is_and), is_and | a_is_and, is_seq, b_is_and)
        instr = set_top(empty_instr(n, b.width, b.height, device), top, a_is_and=a_is_and, b_is_and=b_is_and)

        leaf_table = torch.tensor([_ACTION_TO_LEAF[a] for a in self.action_kinds], dtype=torch.int32, device=device)
        room_mask = b.agent_room_mask(s)
        kinds = []
        for leaf in range(4):
            kind = leaf_table[s_.randint(generator, n, 0, len(self.action_kinds), device).long()]
            # Descriptor 0: any type to go to, a door to open, no door else;
            # descriptor 1 (PutNext's fixed object) any type.
            mode0 = torch.where(kind == LEAF_GOTO, _ALL_TYPES, torch.where(kind == LEAF_OPEN, _DOOR_ONLY, _NO_DOOR))
            mode1 = torch.full_like(mode0, _ALL_TYPES)
            oks = []
            for d, mode in ((0, mode0), (1, mode1)):
                t, col, loc, ok = self._rand_obj(generator, s, room_mask, mode, locked_rect, have_locked)
                instr = set_desc(instr, leaf, d, s.grid, s.agent_pos, s.agent_dir, t, col, loc, agent_room_mask=room_mask)
                oks.append(ok)
            valid &= ~active[leaf] | (oks[0] & ((kind != LEAF_PUTNEXT) | oks[1]))
            kinds.append(torch.where(active[leaf], kind, LEAF_NONE))
        return s, instr.replace(leaf_kind=torch.stack(kinds, dim=1).int()), valid


# -- the Synth family (reference synth.py) -------------------------------------------


class Synth(LevelGen):
    pool_factor = 1.7  # attempt validity 0.71 (SynthS5R2), 0.90

    def __init__(self, room_size=8, num_rows=3, num_cols=3, num_dists=18, **kwargs):
        super().__init__(
            room_size=room_size,
            num_rows=num_rows,
            num_cols=num_cols,
            num_dists=num_dists,
            instr_kinds=["action"],
            locations=False,
            unblocking=True,
            implicit_unlock=False,
            **kwargs,
        )


class SynthLoc(LevelGen):
    pool_factor = 1.3  # attempt validity 0.91

    def __init__(self, **kwargs):
        super().__init__(instr_kinds=["action"], locations=True, unblocking=True, implicit_unlock=False, **kwargs)


class SynthSeq(LevelGen):
    pool_factor = 1.4  # attempt validity 0.84

    def __init__(self, **kwargs):
        super().__init__(locations=True, unblocking=True, implicit_unlock=False, **kwargs)


class MiniBossLevel(LevelGen):
    pool_factor = 1.5  # attempt validity 0.80

    def __init__(self, **kwargs):
        super().__init__(num_cols=2, num_rows=2, room_size=5, num_dists=7, locked_room_prob=0.25, **kwargs)


class BossLevel(LevelGen):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)


class BossLevelNoUnlock(LevelGen):
    pool_factor = 1.3  # attempt validity 0.92

    def __init__(self, **kwargs):
        super().__init__(locked_room_prob=0, implicit_unlock=False, **kwargs)


class GoToSeq(LevelGen):
    """(reference goto.py:527-601)"""

    pool_factor = 2.6  # attempt validity 0.44 (GoToSeqS5R2), 0.52

    def __init__(self, room_size=8, num_rows=3, num_cols=3, num_dists=18, **kwargs):
        super().__init__(
            room_size=room_size,
            num_rows=num_rows,
            num_cols=num_cols,
            num_dists=num_dists,
            action_kinds=["goto"],
            locked_room_prob=0,
            locations=False,
            unblocking=False,
            **kwargs,
        )


class PickupLoc(LevelGen):
    """(reference pickup.py:142-212)"""

    pool_factor = 1.5  # attempt validity 0.82

    def __init__(self, **kwargs):
        super().__init__(
            action_kinds=["pickup"],
            instr_kinds=["action"],
            num_rows=1,
            num_cols=1,
            num_dists=8,
            locked_room_prob=0,
            locations=True,
            unblocking=False,
            **kwargs,
        )
