"""BabyAI level base (reference: minigrid/envs/babyai/core/roomgrid_level.py).

Counterpart of ``minigrid_tpu/envs/babyai/core/level.py``.  A level's
``gen_attempt(generator, n, device) -> (RoomGridState, InstrState, valid)``
makes N attempts at once, in the role of ``gen_mission``; this base wraps it
in the reference's rejection loop (roomgrid_level.py:118-139: envs whose
attempt was rejected draw again, up to ``max_gen_attempts``), adds the
shared instruction validation (:145-198), computes the dynamic step limit
(:70-84) and runs the verifier in ``_post_step`` (:86-103).

A reset cache is generated from a pool (``batch_reset_cache``): single
attempts for ``pool_factor`` times the levels needed, of which the valid
ones are kept in order.  Attempts are independent, so the kept levels have
the rejection loop's distribution without its batched tail, where every env
waits for the slowest.  A pool with too few valid attempts is topped up by
further pools until it has enough; no level is used twice (the JAX package
repeats its valid levels instead, ``minigrid_tpu/envs/babyai/core/
level.py:269,281``).
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core.constants import OBJ_DOOR, OBJ_EMPTY, OBJ_KEY, OBJ_WALL, STATE_LOCKED, cell_color, cell_state, cell_type
from minigrid_tpu_torch.core.roomgrid import RoomGridState
from minigrid_tpu_torch.core.state import EnvState, new_state, resolve_device, tree_map
from minigrid_tpu_torch.core.step import success_reward
from minigrid_tpu_torch.envs.babyai.core.instr import (
    LEAF_PUTNEXT,
    S_FAILURE,
    S_SUCCESS,
    TOP_ACTION,
    InstrState,
    empty_instr,
    num_navs,
    set_desc,
    set_leaf,
    set_top,
    tracked_plane,
    verify_step,
)
from minigrid_tpu_torch.envs.babyai.core.instr_block import BabyAIFusedExt
from minigrid_tpu_torch.envs.babyai.core.text import babyai_mission_text, encode_babyai_mission
from minigrid_tpu_torch.envs.unlock import RoomGridEnvBase
from minigrid_tpu_torch.utils.chunked import cat_trees, chunked, lane_cap
from minigrid_tpu_torch.utils.tree_gather import tree_take

# Rows are words of at most this many bits in check_objs_reachable's flood
# (every registered level is at most 22 cells wide; the JAX package floods
# wider grids cell by cell).
_WORD_BITS = 31


def _dilate4(m: torch.Tensor) -> torch.Tensor:
    """OR of the 4 neighbours of each cell of bool [N, W, H] (zero outside)."""
    out = torch.zeros_like(m)
    out[:, :-1] |= m[:, 1:]
    out[:, 1:] |= m[:, :-1]
    out[:, :, :-1] |= m[:, :, 1:]
    out[:, :, 1:] |= m[:, :, :-1]
    return out


def _reverse_bits(x: torch.Tensor, width: int) -> torch.Tensor:
    """The low ``width`` bits of int64 words ``x`` (< 2^32) reversed."""
    for shift, mask in ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F), (8, 0x00FF00FF)):
        x = ((x & mask) << shift) | ((x >> shift) & mask)
    x = ((x << 16) & 0xFFFFFFFF) | (x >> 16)
    return x >> (32 - width)


def action_instr(builder, s: RoomGridState, kind, d_type, d_color=-1, d_loc=-1, strict=False) -> InstrState:
    """One action instruction of leaf ``kind`` (an int or int32 [N]) on
    descriptor (type, color, loc), resolved on the finished grid of ``s``
    with locations relative to the agent's start room, as the levels of
    open.py, pickup.py, unlock.py and other.py make theirs."""
    instr = empty_instr(s.grid.shape[0], builder.width, builder.height, s.grid.device)
    instr = set_leaf(set_top(instr, TOP_ACTION), 0, kind, strict=strict)
    return set_desc(
        instr, 0, 0, s.grid, s.agent_pos, s.agent_dir, d_type, d_color, d_loc, agent_room_mask=builder.agent_room_mask(s)
    )


def keep_where(mask: torch.Tensor, before, after):
    """``before`` where the env's ``mask`` (bool [N]) is set, else ``after``,
    leaf by leaf (an attempt's construction state undone in some envs)."""
    return tree_map(lambda a, old: torch.where(mask.reshape((-1,) + (1,) * (a.dim() - 1)), old, a), after, before)


class RoomGridLevel(RoomGridEnvBase):
    """Base of the BabyAI levels."""

    # Level-family flag (the reference's levels set it as an attribute).
    unblocking = False
    # Attempts per level in batch_reset_cache's first pool.  Families whose
    # attempts are mostly valid take less (GoToLocal and GoToRedBall* ~0.84
    # valid -> 1.3; the JAX package's measured rates); factor x validity
    # keeps a margin over 1, so that a second pool is rarely drawn.
    pool_factor = 2.0
    fused_ext = BabyAIFusedExt()

    def __init__(
        self,
        room_size: int = 8,
        num_rows: int = 3,
        num_cols: int = 3,
        max_steps: int | None = None,
        max_gen_attempts: int = 200,
        **kwargs,
    ):
        self.fixed_max_steps = max_steps is not None
        super().__init__(room_size, num_rows, num_cols, max_steps if max_steps is not None else 0, **kwargs)
        self.max_gen_attempts = max_gen_attempts

    # -- provided by the levels ----------------------------------------------
    def gen_attempt(self, generator: torch.Generator | None, n: int, device):
        """N mission-generation attempts: (RoomGridState, InstrState, valid
        bool [N]), ``valid`` folding in the level's own rejection rules;
        the base adds the shared instruction validation."""
        raise NotImplementedError

    # -- shared validation (reference roomgrid_level.py:145-198) ---------------
    def _validate(self, s: RoomGridState, instr: InstrState) -> torch.Tensor:
        # A placement that found no free cell aborts the attempt (the
        # reference's place_obj RecursionError).
        ok = s.ok.clone()
        for leaf in range(4):
            kind = instr.leaf_kind[:, leaf]
            is_put = kind == LEAF_PUTNEXT
            move = tracked_plane(instr.gridm, leaf, 0)
            fixed = tracked_plane(instr.gridm, leaf, 1)
            # PutNext (:159-176): the two descriptor sets must not intersect
            # and must not be next to each other already.
            intersects = (move & fixed).flatten(1).any(dim=1)
            already_next = (_dilate4(fixed) & move).flatten(1).any(dim=1)
            ok &= ~(is_put & (intersects | already_next))
            # Every active descriptor matches an object (the reference
            # asserts it when it makes the surface string).
            has0, has1 = move.flatten(1).any(dim=1), fixed.flatten(1).any(dim=1)
            ok &= (kind < 0) | (has0 & (~is_put | has1))
        if self.unblocking:
            # No instruction may name a key of a locked door's color
            # (:149-191); a descriptor without a color passes, as the
            # reference compares the color attribute.
            grid = s.grid
            locked_door = (cell_type(grid) == OBJ_DOOR) & (cell_state(grid) == STATE_LOCKED)
            colors = cell_color(grid)
            locked_colors = torch.stack([(locked_door & (colors == c)).flatten(1).any(dim=1) for c in range(6)], dim=1)
            rows = torch.arange(grid.shape[0], device=grid.device)
            for leaf in range(4):
                for d in range(2):
                    color = instr.d_color[:, leaf, d]
                    bad = (
                        (instr.d_type[:, leaf, d] == OBJ_KEY)
                        & (color >= 0)
                        & locked_colors[rows, color.clamp(0, 5).long()]
                    )
                    ok &= ~((instr.leaf_kind[:, leaf] >= 0) & bad)
        return ok

    def check_objs_reachable(self, s: RoomGridState) -> torch.Tensor:
        """bool [N]: every object reachable from the agent without moving
        anything (reference roomgrid_level.py:249-301): a flood through
        empty and door cells that also reaches the cells next to them.

        Each grid row is one word (bit x for column x): the flood spreads
        along a row in closed carry form, ``m | (((m & open) + open) ^
        open)`` (the other way on bit-reversed words), and between rows by
        one shifted OR of its open cells, until no env's flood grows."""
        grid = s.grid
        n, w, h = grid.shape
        t = cell_type(grid)
        objects = (t != OBJ_EMPTY) & (t != OBJ_WALL)
        passable = (t == OBJ_EMPTY) | (t == OBJ_DOOR)
        ax, ay = s.agent_pos[:, 0].long(), s.agent_pos[:, 1].long()
        if w > _WORD_BITS:
            raise ValueError(f"a grid row of {w} cells does not fit the flood's {_WORD_BITS}-bit words")
        weights = (1 << torch.arange(w, device=grid.device, dtype=torch.int64))[None, :, None]
        ow = (passable.long() * weights).sum(dim=1)  # [N, H]
        owr = _reverse_bits(ow, w)
        full = (1 << w) - 1
        m = torch.zeros((n, h), dtype=torch.int64, device=grid.device)
        m[torch.arange(n, device=grid.device), ay] = 1 << ax

        def flood_right(m, tw):
            return m | ((((m & tw) + tw) & full) ^ tw)

        while True:
            m2 = flood_right(m, ow)
            m2 = m2 | _reverse_bits(flood_right(_reverse_bits(m2, w), owr), w)
            lit = m2 & ow
            grown = m2.clone()
            grown[:, :-1] |= lit[:, 1:]
            grown[:, 1:] |= lit[:, :-1]
            if torch.equal(grown, m):
                break
            m = grown
        obj_w = (objects.long() * weights).sum(dim=1)
        return ((obj_w & ~m) == 0).all(dim=1)

    # -- generation ---------------------------------------------------------------
    def _attempt(self, generator, n: int, device):
        s, instr, valid = self.gen_attempt(generator, n, device)
        return s, instr, valid & self._validate(s, instr)

    def _generate(self, num_envs: int, generator: torch.Generator | None, device) -> EnvState:
        """The rejection loop: every env whose attempt was rejected draws a
        new one, up to ``max_gen_attempts`` more (after which the last
        attempt stands, as in the JAX package)."""
        s, instr, valid = self._attempt(generator, num_envs, device)
        for _ in range(self.max_gen_attempts):
            redo = torch.nonzero(~valid, as_tuple=True)[0]
            if redo.numel() == 0:
                break
            s2, i2, v2 = self._attempt(generator, redo.numel(), device)
            s, instr = tree_map(lambda a, b: a.index_copy(0, redo, b), (s, instr), (s2, i2))
            valid = valid.index_copy(0, redo, v2)
        return self._finish_level(s, instr)

    def _finish_level(self, s: RoomGridState, instr: InstrState) -> EnvState:
        """The episodes of accepted attempts: the dynamic step limit
        (reference roomgrid_level.py:76-83) and the mission encoding."""
        if self.fixed_max_steps:
            max_steps = self.max_steps
        else:
            b = self.builder
            max_steps = num_navs(instr) * (b.room_size**2 * b.num_rows * b.num_cols)
        return new_state(
            s.grid,
            s.agent_pos,
            s.agent_dir,
            max_steps,
            mission=encode_babyai_mission(instr),
            extra={"instr": instr},
        )

    def batch_reset_cache(
        self, num_envs: int, num_resets: int, generator: torch.Generator | None = None, device=None
    ) -> EnvState:
        """Reset cache [num_envs, num_resets, ...] from a pool of
        ``pool_factor`` x N x R single attempts, generated in chunks of
        bounded memory (``utils/chunked.py``), whose valid attempts are kept
        in order.  While the kept ones are fewer than N x R, a further pool
        sized by the validity seen so far is drawn; each level is used once.
        Raises if more than ``max_gen_attempts`` attempts a level were
        drawn, the bound of the rejection loop."""
        device = resolve_device(generator, device)
        total = num_envs * num_resets
        cap = lane_cap(self.width * self.height)
        kept, found, drawn = [], 0, 0
        pool = int(total * self.pool_factor)
        while found < total:
            if drawn >= total * self.max_gen_attempts:
                raise RuntimeError(f"{type(self).__name__}: {found} valid levels of {drawn} attempts, {total} needed")
            s, instr, valid = chunked(lambda count: self._attempt(generator, count, device), pool, cap)
            index = torch.nonzero(valid, as_tuple=True)[0][: total - found]
            kept.append(tree_take((s, instr), index))
            found, drawn = found + index.numel(), drawn + pool
            # The shortfall over the validity seen so far, with a margin.
            pool = int((total - found) * 1.25 * drawn / max(found, 1)) + 64
        s, instr = kept[0] if len(kept) == 1 else cat_trees(kept)
        states = self._finish_level(s, instr)
        return states.map(lambda a: a.reshape((num_envs, num_resets) + a.shape[1:]))

    # -- the verifier ---------------------------------------------------------------
    def _post_step(self, prev, state, action, reward):
        instr, status = verify_step(state.extra["instr"], prev, state, action)
        reward = torch.where(status == S_SUCCESS, success_reward(state.step_count, state.max_steps), reward)
        reward = torch.where(status == S_FAILURE, 0.0, reward)
        return state.replace(terminated=state.terminated | (status != 0), extra={"instr": instr}), reward

    def mission_text(self, mission) -> str:
        return babyai_mission_text(mission)
