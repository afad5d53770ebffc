"""The BabyAI verifier as a fused-kernel extension: the Python side.

Counterpart of ``minigrid_tpu/envs/babyai/core/instr_block.py``.  The
``InstrState`` of an env packs into 8 int32 extra scalars and 2 extra planes
of W*H cells (``pack_extra``/``pack_planes``):

* word 0 ``top``:  bits 0-1 top_kind, 2 a_is_and, 3 b_is_and, 4 strict,
  5 done_mode;
* word 1 ``leaf``: bits 3l..3l+2 leaf_kind+1 of leaf l, bit 12+l its
  leaf_strict;
* words 2-4 ``d_type``, ``d_color``, ``d_loc``: nibble leaf*2+d holds the
  value + 1;
* word 5 ``d_plural`` and word 6 ``carried``: bit leaf*2+d;
* word 7 ``mem``: bits 0-3 pre_none, 4-7 pre_move_tracked, 8-11
  last_match, 12-15 sub_succ, 16 a_succ, 17 b_succ;
* plane 0 ``gridm``, plane 1 ``poss``: bit leaf*2+d of each cell, so every
  value fits in 8 bits (the kernels carry the planes as bytes).

``post_step`` is the plain twin of the kernels' hook
(``csrc/ext/babyai.cuh``): ``instr.verify_step`` on the packed words, then
``RoomGridLevel._post_step``'s overlay.  Like the hook it reads single
words: the ``gridm`` word at the front cell of the pose before the step,
the ``poss`` words at the front cell after it and at that cell's 4
neighbours, and its one whole-plane pass is ``poss = gridm`` on a drop
action.  The levels' own ``_post_step`` runs ``verify_step`` itself, as the
JAX package's does; a CPU test holds the two to each other.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core.actions import Actions
from minigrid_tpu_torch.core.constants import OBJ_BOX, OBJ_DOOR, STATE_OPEN
from minigrid_tpu_torch.core.step import success_reward
from minigrid_tpu_torch.envs.babyai.core.instr import (
    LEAF_GOTO,
    LEAF_OPEN,
    LEAF_PICKUP,
    S_CONTINUE,
    S_FAILURE,
    S_SUCCESS,
    TOP_ACTION,
    TOP_AFTER,
    TOP_AND,
    TOP_BEFORE,
    InstrState,
    front_index,
    near_word,
    plane_at,
)
from minigrid_tpu_torch.ops import fused_ext as fx

_SLOT_SHIFT = (torch.arange(4)[:, None] * 2 + torch.arange(2)).int()  # [4, 2]
_LEAF = torch.arange(4).int()


def _pack_bits42(flags):
    """bool [..., 4, 2] -> int32 [...] (bit leaf*2 + d)."""
    return torch.where(flags, 1 << _SLOT_SHIFT.to(flags.device), 0).sum(dim=(-2, -1), dtype=torch.int32)


def _unpack_bits42(word):
    return ((word[..., None, None] >> _SLOT_SHIFT.to(word.device)) & 1) != 0


def _pack_nib42(vals):
    """int [..., 4, 2] in [-1, 14] -> int32 [...]: nibble leaf*2 + d holds
    value + 1."""
    return ((vals.int() + 1) << (_SLOT_SHIFT.to(vals.device) * 4)).sum(dim=(-2, -1), dtype=torch.int32)


def _unpack_nib42(word):
    return ((word[..., None, None] >> (_SLOT_SHIFT.to(word.device) * 4)) & 0xF) - 1


def _pack_bits4(flags, off: int):
    """bool [..., 4] -> int32 [...] bits off..off+3."""
    return torch.where(flags, 1 << (_LEAF.to(flags.device) + off), 0).sum(dim=-1, dtype=torch.int32)


def _unpack_bits4(word, off: int):
    return ((word[..., None] >> (_LEAF.to(word.device) + off)) & 1) != 0


def _bit(word, b: int):
    return ((word >> b) & 1) != 0


class BabyAIFusedExt(fx.CachedExt):
    """The verifier's state and hook for the kernels (``csrc/ext/
    babyai.cuh``): 8 extra scalars and 2 planes, blended from the reset
    cache at every reset."""

    n_scalars = 8
    n_planes = 2
    kernel_id = 6
    # Objects, a per-episode mission, walls that occlude.
    kernel_switches = (False, False, False)

    def pack_extra(self, env, extra):
        ins: InstrState = extra["instr"]
        top = (
            ins.top_kind
            | (ins.a_is_and.int() << 2)
            | (ins.b_is_and.int() << 3)
            | (ins.strict.int() << 4)
            | (ins.done_mode.int() << 5)
        )
        leaf = ((ins.leaf_kind + 1) << (_LEAF.to(top.device) * 3)).sum(dim=-1, dtype=torch.int32)
        leaf = leaf | _pack_bits4(ins.leaf_strict, 12)
        mem = (
            _pack_bits4(ins.pre_none, 0)
            | _pack_bits4(ins.pre_move_tracked, 4)
            | _pack_bits4(ins.last_match, 8)
            | _pack_bits4(ins.sub_succ, 12)
            | (ins.a_succ.int() << 16)
            | (ins.b_succ.int() << 17)
        )
        words = (
            top,
            leaf,
            _pack_nib42(ins.d_type),
            _pack_nib42(ins.d_color),
            _pack_nib42(ins.d_loc),
            _pack_bits42(ins.d_plural),
            _pack_bits42(ins.carried),
            mem,
        )
        return torch.stack([w.int() for w in words], dim=-1)

    def pack_planes(self, env, extra):
        ins: InstrState = extra["instr"]
        lead = ins.gridm.shape[:-2]
        return torch.stack([ins.gridm.reshape(lead + (-1,)), ins.poss.reshape(lead + (-1,))], dim=-2).int()

    def unpack_extra(self, env, scal, planes=None):
        top, leaf, dtp, dcl, dlc, dpl, carried, mem = (scal[..., k] for k in range(8))
        lead = top.shape
        shifts = _LEAF.to(scal.device) * 3
        return {
            "instr": InstrState(
                top_kind=top & 3,
                a_is_and=_bit(top, 2),
                b_is_and=_bit(top, 3),
                strict=_bit(top, 4),
                leaf_kind=((leaf[..., None] >> shifts) & 7) - 1,
                leaf_strict=_unpack_bits4(leaf, 12),
                d_type=_unpack_nib42(dtp),
                d_color=_unpack_nib42(dcl),
                d_loc=_unpack_nib42(dlc),
                d_plural=_unpack_bits42(dpl),
                poss=planes[..., 1, :].reshape(lead + (env.width, env.height)).int(),
                gridm=planes[..., 0, :].reshape(lead + (env.width, env.height)).int(),
                carried=_unpack_bits42(carried),
                pre_none=_unpack_bits4(mem, 0),
                pre_move_tracked=_unpack_bits4(mem, 4),
                done_mode=_bit(top, 5),
                last_match=_unpack_bits4(mem, 8),
                a_succ=_bit(mem, 16),
                b_succ=_bit(mem, 17),
                sub_succ=_unpack_bits4(mem, 12),
            )
        }

    def post_step(self, env, prev, state, action, reward, scal, planes=None):
        """``verify_step`` on the packed words of ``scal`` int32 [N, 8] and
        ``planes`` int32 [N, 2, W*H], then the level's overlay.  Returns
        (termination, reward, scal, planes)."""
        a = action.int()
        topw, leafw, carried, mem = scal[:, 0], scal[:, 1], scal[:, 6], scal[:, 7]
        gridm, poss = planes[:, 0], planes[:, 1]
        n = a.shape[0]
        fidx = front_index(prev)
        prev_held = (prev.carrying & 0xFF) != 0
        now_held = (state.carrying & 0xFF) != 0
        picked, dropped = ~prev_held & now_held, prev_held & ~now_held
        flat_prev, flat_post = prev.grid.reshape(n, -1), state.grid.reshape(n, -1)
        box_consumed = (
            (a == Actions.toggle)
            & ((flat_prev.gather(1, fidx[:, None])[:, 0] & 0xFF) == OBJ_BOX)
            & ((flat_post.gather(1, fidx[:, None])[:, 0] & 0xFF) != OBJ_BOX)
        )

        # Object bookkeeping (verify_step): the one gridm word that changes.
        at_fwd = gridm.gather(1, fidx[:, None])[:, 0]
        carried_old = carried
        carried = torch.where(picked, carried | at_fwd, carried)
        word = torch.where(picked | box_consumed, 0, torch.where(dropped, at_fwd | carried_old, at_fwd))
        carried = torch.where(dropped, 0, carried)
        gridm = gridm.scatter(1, fidx[:, None], word[:, None])
        poss = torch.where((a == Actions.drop)[:, None], gridm, poss)

        # Each leaf's candidate status.
        fidx_now = front_index(state)
        fcell_now = plane_at(state.grid, fidx_now)
        fnow_type, fnow_state = fcell_now & 0xFF, (fcell_now >> 16) & 0xFF
        w, h = env.width, env.height
        poss_now = poss.gather(1, fidx_now[:, None])[:, 0]
        near = near_word(poss.reshape(n, w, h), fidx_now)
        done_mode = _bit(topw, 5)
        is_done_act = done_mode & (a == Actions.done)
        raw_status, leaf_status = [], []
        for leaf in range(4):
            kind = ((leafw >> (3 * leaf)) & 7) - 1
            strict = _bit(leafw, 12 + leaf)
            b0, b1 = 2 * leaf, 2 * leaf + 1
            open_succ = (a == Actions.toggle) & _bit(word, b0) & (fnow_type == OBJ_DOOR) & (fnow_state == STATE_OPEN)
            open_fail = strict & (a == Actions.toggle) & (fnow_type == OBJ_DOOR) & ~open_succ
            goto_succ = _bit(poss_now, b0)
            pickup_succ = (a == Actions.pickup) & _bit(mem, leaf) & _bit(carried, b0)
            pickup_fail = strict & (a == Actions.pickup) & now_held & ~pickup_succ
            put_succ = (a == Actions.drop) & dropped & _bit(mem, 4 + leaf) & _bit(near, b1)
            put_fail = strict & (a == Actions.pickup) & now_held
            k_open, k_goto, k_pick = kind == LEAF_OPEN, kind == LEAF_GOTO, kind == LEAF_PICKUP
            k_put = ~k_open & ~k_goto & ~k_pick
            succ = (k_open & open_succ) | (k_goto & goto_succ) | (k_pick & pickup_succ) | (k_put & put_succ)
            fail = ((k_open & open_fail) | (k_pick & pickup_fail) | (k_put & put_fail)) & ~succ
            raw = torch.where(kind == -1, S_CONTINUE, torch.where(succ, S_SUCCESS, torch.where(fail, S_FAILURE, S_CONTINUE)))
            raw_status.append(raw)
            done_leaf = torch.where(_bit(mem, 8 + leaf), S_SUCCESS, S_FAILURE)
            leaf_status.append(torch.where(done_mode, torch.where(is_done_act, done_leaf, S_CONTINUE), raw))

        # The combinators.
        top_kind = topw & 3
        a_is_and, b_is_and, strict_top = _bit(topw, 2), _bit(topw, 3), _bit(topw, 4)
        sub = [_bit(mem, 12 + leaf) for leaf in range(4)]
        a_prior, b_prior = _bit(mem, 16), _bit(mem, 17)

        def side(is_and, i0, i1, prior):
            s0 = torch.where(sub[i0], S_SUCCESS, leaf_status[i0])
            s1 = torch.where(sub[i1], S_SUCCESS, leaf_status[i1])
            both = torch.where((s0 == S_SUCCESS) & (s1 == S_SUCCESS), S_SUCCESS, S_CONTINUE)
            return torch.where(is_and, both, torch.where(prior, S_SUCCESS, leaf_status[i0]))

        def then(first, first_prior, second):
            return torch.where(
                first_prior | (first == S_SUCCESS),
                torch.where(second == S_FAILURE, S_FAILURE, torch.where(second == S_SUCCESS, S_SUCCESS, S_CONTINUE)),
                torch.where(first == S_FAILURE, S_FAILURE, torch.where(strict_top & (second == S_SUCCESS), S_FAILURE, S_CONTINUE)),
            )

        a_status = side(a_is_and, 0, 1, a_prior)
        b_status = side(b_is_and, 2, 3, b_prior)
        is_action, is_and = top_kind == TOP_ACTION, top_kind == TOP_AND
        is_before, is_after = top_kind == TOP_BEFORE, top_kind == TOP_AFTER
        status = torch.where(
            is_action,
            leaf_status[0],
            torch.where(
                is_and,
                side(torch.ones_like(a_is_and), 0, 1, torch.zeros_like(a_prior)),
                torch.where(is_before, then(a_status, a_prior, b_status), then(b_status, b_prior, a_status)),
            ),
        )

        # Called leaves, their memory, the stickies.
        a_called = is_action | is_and | (is_before & ~a_prior) | (is_after & (b_prior | (b_status == S_SUCCESS) | strict_top))
        b_called = is_and | (is_before & (a_prior | (a_status == S_SUCCESS) | strict_top)) | (is_after & ~b_prior)
        called = [a_called & ~sub[0], a_called & a_is_and & ~sub[1], b_called & ~sub[2], b_called & b_is_and & ~sub[3]]
        new_mem = torch.zeros_like(mem)
        for leaf in range(4):
            mu = called[leaf] & ~is_done_act
            pre_none = torch.where(mu, ~now_held, _bit(mem, leaf))
            pre_move = torch.where(mu, _bit(carried, 2 * leaf), _bit(mem, 4 + leaf))
            last = torch.where(done_mode & mu, raw_status[leaf] == S_SUCCESS, _bit(mem, 8 + leaf))
            sticky = sub[leaf] | (called[leaf] & (leaf_status[leaf] == S_SUCCESS))
            new_mem |= (pre_none.int() << leaf) | (pre_move.int() << (4 + leaf))
            new_mem |= (last.int() << (8 + leaf)) | (sticky.int() << (12 + leaf))
        a_live = is_before | (is_after & (b_prior | (b_status == S_SUCCESS)))
        b_live = is_after | (is_before & (a_prior | (a_status == S_SUCCESS)))
        new_mem |= ((a_prior | (a_live & (a_status == S_SUCCESS))).int() << 16)
        new_mem |= ((b_prior | (b_live & (b_status == S_SUCCESS))).int() << 17)

        # RoomGridLevel._post_step's overlay.
        reward = torch.where(
            status == S_SUCCESS,
            success_reward(state.step_count, state.max_steps),
            torch.where(status == S_FAILURE, 0.0, reward),
        )
        scal = torch.cat([scal[:, :6], carried[:, None], new_mem[:, None]], dim=1)
        return status != S_CONTINUE, reward, scal, torch.stack([gridm, poss], dim=1)
