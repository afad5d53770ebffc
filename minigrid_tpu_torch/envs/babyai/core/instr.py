"""BabyAI instructions as fixed slots, and the verifier, batched.

Counterpart of ``minigrid_tpu/envs/babyai/core/instr.py`` (the reference
verifier's object graph, minigrid/envs/babyai/core/verifier.py:49-566).  An
instruction is an ``InstrState`` of tensors with a leading env axis:

* at most 4 leaf action instructions (slots a1, a2, b1, b2), which covers
  every shape the grammar makes: Action, And(a1, a2), Before/After(x, y)
  with x and y an Action or an And;
* up to 2 object descriptors per leaf (PutNext uses both);
* object identity tracking (the reference's ``obj_set``/``obj_poss``,
  verifier.py:104-169) as per-descriptor cell masks packed into one int32
  [W, H] plane each, bit ``leaf*2 + slot``: ``gridm`` marks the cells that
  hold a tracked object now, ``poss`` the positions the verifier sees
  (refreshed only on a drop action, as roomgrid_level.py:89-91 does), and
  ``carried`` flags a tracked object in hand.

Statuses: 0 continue, 1 success, 2 failure.

Done-actions mode (reference verifier.py:25, the environment variable
``BABYAI_DONE_ACTIONS``): a leaf swallows every status on other actions and
only records whether the action just satisfied it (``lastStepMatch``,
verifier.py:225-237); a ``done`` action then reports success or failure
from that record.  The variable is read when an instruction is created
(``empty_instr``), as the JAX package reads it.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

import torch

from minigrid_tpu_torch.core.actions import Actions
from minigrid_tpu_torch.core.constants import OBJ_BOX, OBJ_DOOR, STATE_OPEN, cell_color, cell_state, cell_type, dir_vec

# Leaf kinds.
LEAF_NONE = -1
LEAF_OPEN = 0
LEAF_GOTO = 1
LEAF_PICKUP = 2
LEAF_PUTNEXT = 3

# Top-level shapes.
TOP_ACTION = 0
TOP_AND = 1
TOP_BEFORE = 2
TOP_AFTER = 3

S_CONTINUE = 0
S_SUCCESS = 1
S_FAILURE = 2

# Location vocabulary (reference verifier.py:21).
LOC_LEFT, LOC_RIGHT, LOC_FRONT, LOC_BEHIND = 0, 1, 2, 3


def use_done_actions() -> bool:
    """Whether the verifier runs in done-actions mode: ``BABYAI_DONE_ACTIONS``
    set to anything non-empty (the reference reads it at import, the JAX
    package and this one when an instruction is made)."""
    return bool(os.environ.get("BABYAI_DONE_ACTIONS", False))


@dataclass
class InstrState:
    # -- the description, fixed per episode --
    top_kind: torch.Tensor  # int32 [N]
    a_is_and: torch.Tensor  # bool [N]
    b_is_and: torch.Tensor  # bool [N]
    strict: torch.Tensor  # bool [N] (sequence-level strict)
    leaf_kind: torch.Tensor  # int32 [N, 4]
    leaf_strict: torch.Tensor  # bool [N, 4]
    d_type: torch.Tensor  # int32 [N, 4, 2] (-1 none)
    d_color: torch.Tensor  # int32 [N, 4, 2] (-1 none)
    d_loc: torch.Tensor  # int32 [N, 4, 2] (-1 none)
    d_plural: torch.Tensor  # bool [N, 4, 2] (more than one match at reset)
    # -- tracking, bit leaf*2 + slot of each cell --
    poss: torch.Tensor  # int32 [N, W, H]
    gridm: torch.Tensor  # int32 [N, W, H]
    carried: torch.Tensor  # bool [N, 4, 2]
    # -- per-leaf memory (the reference's preCarrying, updated only when the
    #    leaf's verify is called) --
    pre_none: torch.Tensor  # bool [N, 4]
    pre_move_tracked: torch.Tensor  # bool [N, 4]
    # -- done-actions mode (reference verifier.py:25, 219-237) --
    done_mode: torch.Tensor  # bool [N]
    last_match: torch.Tensor  # bool [N, 4] (per-leaf lastStepMatch)
    # -- combinators --
    a_succ: torch.Tensor  # bool [N]
    b_succ: torch.Tensor  # bool [N]
    sub_succ: torch.Tensor  # bool [N, 4] (sticky leaf successes inside an And)

    def replace(self, **changes) -> InstrState:
        return dataclasses.replace(self, **changes)


def empty_instr(n: int, width: int, height: int, device=None, done_mode: bool | None = None) -> InstrState:
    """N empty instructions over a W x H grid."""
    if done_mode is None:
        done_mode = use_done_actions()

    def full(shape, value, dtype):
        return torch.full((n,) + shape, value, dtype=dtype, device=device)

    return InstrState(
        top_kind=full((), TOP_ACTION, torch.int32),
        a_is_and=full((), False, torch.bool),
        b_is_and=full((), False, torch.bool),
        strict=full((), False, torch.bool),
        leaf_kind=full((4,), LEAF_NONE, torch.int32),
        leaf_strict=full((4,), False, torch.bool),
        d_type=full((4, 2), -1, torch.int32),
        d_color=full((4, 2), -1, torch.int32),
        d_loc=full((4, 2), -1, torch.int32),
        d_plural=full((4, 2), False, torch.bool),
        poss=full((width, height), 0, torch.int32),
        gridm=full((width, height), 0, torch.int32),
        carried=full((4, 2), False, torch.bool),
        pre_none=full((4,), True, torch.bool),
        pre_move_tracked=full((4,), False, torch.bool),
        done_mode=full((), bool(done_mode), torch.bool),
        last_match=full((4,), False, torch.bool),
        a_succ=full((), False, torch.bool),
        b_succ=full((), False, torch.bool),
        sub_succ=full((4,), False, torch.bool),
    )


_SLOT_BITS = (torch.arange(4)[:, None] * 2 + torch.arange(2)).int()  # [4, 2]


def unpack_slots(bits: torch.Tensor) -> torch.Tensor:
    """int32 [...] packed slot bits -> bool [..., 4, 2]."""
    return ((bits[..., None, None] >> _SLOT_BITS.to(bits.device)) & 1) != 0


def pack_slots(flags: torch.Tensor) -> torch.Tensor:
    """bool [..., 4, 2] -> packed int32 [...]."""
    weights = (1 << _SLOT_BITS).to(flags.device)
    return torch.where(flags, weights, 0).sum(dim=(-2, -1), dtype=torch.int32)


def tracked_plane(bits: torch.Tensor, leaf: int, d: int) -> torch.Tensor:
    """bool mask of slot (leaf, d) of a packed plane."""
    return ((bits >> (leaf * 2 + d)) & 1) != 0


def _per_env(v):
    return v[:, None, None]


def desc_match_mask(grid, d_type, d_color, d_loc, agent_pos, agent_dir, agent_room_mask=None) -> torch.Tensor:
    """bool [N, W, H]: the objects an initial ``find_matching_objs``
    (reference verifier.py:104-169) finds for descriptor (type, color, loc),
    each int32 [N] with -1 for none: cells whose object matches type and
    color and, with a location, the direction predicate relative to the
    agent's start pose, within the agent's start room (``agent_room_mask``,
    bool [N, W, H], or None)."""
    _, w, h = grid.shape
    t, c = cell_type(grid), cell_color(grid)
    # Every non-empty object cell is a candidate (verifier.py:120-124).
    m = t >= 2
    m = m & torch.where(_per_env(d_type) >= 0, t == _per_env(d_type), True)
    m = m & torch.where(_per_env(d_color) >= 0, c == _per_env(d_color), True)
    xs = torch.arange(w, dtype=torch.int32, device=grid.device)[:, None]
    ys = torch.arange(h, dtype=torch.int32, device=grid.device)[None, :]
    vx = xs - _per_env(agent_pos[:, 0])
    vy = ys - _per_env(agent_pos[:, 1])
    d1x, d1y = (_per_env(v) for v in dir_vec(agent_dir))
    # The right vector the reference uses (verifier.py:150-152).
    dot1 = vx * d1x + vy * d1y
    dot2 = vx * -d1y + vy * d1x
    loc = _per_env(d_loc)
    loc_ok = torch.where(
        loc == LOC_LEFT, dot2 < 0, torch.where(loc == LOC_RIGHT, dot2 > 0, torch.where(loc == LOC_FRONT, dot1 > 0, dot1 < 0))
    )
    if agent_room_mask is not None:
        loc_ok = loc_ok & agent_room_mask
    return m & torch.where(loc >= 0, loc_ok, True)


def front_index(state) -> torch.Tensor:
    """int64 [N]: the flat index x*H + y of the cell in front of the agent,
    clamped into the grid."""
    _, w, h = state.grid.shape
    dx, dy = dir_vec(state.agent_dir)
    fx = (state.agent_x + dx).clamp(0, w - 1)
    fy = (state.agent_y + dy).clamp(0, h - 1)
    return (fx * h + fy).long()


def plane_at(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``plane`` [N, W, H] at flat index ``idx`` [N] of each env."""
    return plane.reshape(plane.shape[0], -1).gather(1, idx[:, None])[:, 0]


def near_word(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """OR of ``plane`` [N, W, H] over the 4 neighbours of flat cell ``idx``
    [N] that lie in the grid: the 4-dilation of the plane (zero outside),
    read at ``idx``."""
    n, w, h = plane.shape
    x, y = idx // h, idx % h
    flat = plane.reshape(n, -1)
    word = torch.zeros(n, dtype=plane.dtype, device=plane.device)
    for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        nx, ny = x + dx, y + dy
        inside = (nx >= 0) & (nx < w) & (ny >= 0) & (ny < h)
        value = flat.gather(1, (nx.clamp(0, w - 1) * h + ny.clamp(0, h - 1))[:, None])[:, 0]
        word = word | torch.where(inside, value, 0)
    return word


def _leaf_statuses(instr: InstrState, prev_state, state, action, fidx_prev) -> torch.Tensor:
    """int32 [N, 4]: each leaf's candidate status given its memory."""
    a = action[:, None]
    fidx_now = front_index(state)
    fcell_now = plane_at(state.grid, fidx_now)[:, None]
    fnow_type, fnow_state = cell_type(fcell_now), cell_state(fcell_now)
    carrying_now = ((state.carrying & 0xFF) != 0)[:, None]
    dropped = (((prev_state.carrying & 0xFF) != 0)[:, None]) & ~carrying_now
    at_fwd_prev = unpack_slots(plane_at(instr.gridm, fidx_prev))
    poss_at_now = unpack_slots(plane_at(instr.poss, fidx_now))
    # PutNext's "next to a tracked fixed position": the 4-dilation of poss,
    # an OR of shifted planes, distributes over the packed bits.
    near_bits = unpack_slots(near_word(instr.poss, fidx_now))
    kind, strict = instr.leaf_kind, instr.leaf_strict
    # OPEN (verifier.py:268-285): toggle onto a tracked door that is now open.
    open_succ = (a == Actions.toggle) & at_fwd_prev[..., 0] & (fnow_type == OBJ_DOOR) & (fnow_state == STATE_OPEN)
    open_fail = strict & (a == Actions.toggle) & (fnow_type == OBJ_DOOR) & ~open_succ
    # GOTO (verifier.py:307-314): facing a tracked position.
    goto_succ = poss_at_now[..., 0]
    # PICKUP (verifier.py:341-361).
    pickup_succ = (a == Actions.pickup) & instr.pre_none & instr.carried[..., 0]
    pickup_fail = strict & (a == Actions.pickup) & carrying_now & ~pickup_succ
    # PUTNEXT (verifier.py:409-433): a tracked moving object dropped next to
    # a tracked fixed position (poss refreshed before the verifier runs).
    put_succ = (a == Actions.drop) & dropped & instr.pre_move_tracked & near_bits[..., 1]
    put_fail = strict & (a == Actions.pickup) & carrying_now
    succ = torch.where(
        kind == LEAF_OPEN, open_succ, torch.where(kind == LEAF_GOTO, goto_succ, torch.where(kind == LEAF_PICKUP, pickup_succ, put_succ))
    )
    fail = torch.where(
        kind == LEAF_OPEN, open_fail, torch.where(kind == LEAF_GOTO, False, torch.where(kind == LEAF_PICKUP, pickup_fail, put_fail))
    ) & ~succ
    status = torch.where(succ, S_SUCCESS, torch.where(fail, S_FAILURE, S_CONTINUE))
    return torch.where(kind == LEAF_NONE, S_CONTINUE, status).int()


def _side_status(instr: InstrState, leaf_status, side_is_and, i0: int, i1: int, side_succ_prior) -> torch.Tensor:
    """Status of one sequence side, a leaf or an And of two leaves.  An And
    gates which leaves are called by their sticky successes and swallows
    failures (AndInstr.verify, verifier.py:552-566; its done-actions
    branch compares the action by identity and never fires through the gym
    interface, so an And never fails on a done action here either)."""
    s0 = torch.where(instr.sub_succ[:, i0], S_SUCCESS, leaf_status[:, i0])
    s1 = torch.where(instr.sub_succ[:, i1], S_SUCCESS, leaf_status[:, i1])
    and_status = torch.where((s0 == S_SUCCESS) & (s1 == S_SUCCESS), S_SUCCESS, S_CONTINUE)
    single = torch.where(side_succ_prior, S_SUCCESS, leaf_status[:, i0])
    return torch.where(side_is_and, and_status, single)


def verify_step(instr: InstrState, prev_state, state, action):
    """Object bookkeeping and one tick of the instruction machine, as
    RoomGridLevel.step does it (roomgrid_level.py:86-103): positions
    through pickup, drop and box opening, ``poss`` refreshed on a drop
    action, then the statuses.  ``prev_state``/``state`` are the batch
    before and after the core step, ``action`` int32 [N].  Returns (instr,
    status int32 [N])."""
    a = action.int()
    fidx_prev = front_index(prev_state)
    prev_held = (prev_state.carrying & 0xFF) != 0
    now_held = (state.carrying & 0xFF) != 0
    picked = ~prev_held & now_held
    dropped = prev_held & ~now_held
    box_consumed = (
        (a == Actions.toggle)
        & (cell_type(plane_at(prev_state.grid, fidx_prev)) == OBJ_BOX)
        & (cell_type(plane_at(state.grid, fidx_prev)) != OBJ_BOX)
    )
    word = plane_at(instr.gridm, fidx_prev)
    at_fwd = unpack_slots(word)
    # A pickup moves a tracked object from the grid into the hand, a drop
    # puts it back at the front cell; opening a box destroys the tracked
    # box (its contents are new objects).
    carried = torch.where(picked[:, None, None], instr.carried | at_fwd, instr.carried)
    word = torch.where(picked, 0, word)
    word = torch.where(dropped, word | pack_slots(carried), word)
    carried = torch.where(dropped[:, None, None], False, carried)
    word = torch.where(box_consumed, 0, word)
    n = word.shape[0]
    gridm = instr.gridm.reshape(n, -1).scatter(1, fidx_prev[:, None], word[:, None]).reshape(instr.gridm.shape)
    # update_objs_poss on a drop action (roomgrid_level.py:89-91).
    poss = torch.where(_per_env(a == Actions.drop), gridm, instr.poss)
    instr = instr.replace(gridm=gridm, carried=carried, poss=poss)

    raw_status = _leaf_statuses(instr, prev_state, state, a, fidx_prev)
    # Done-actions mode (verifier.py:225-237).
    done_mode = instr.done_mode[:, None]
    is_done_act = instr.done_mode & (a == Actions.done)
    done_leaf = torch.where(instr.last_match, S_SUCCESS, S_FAILURE)
    leaf_status = torch.where(done_mode, torch.where(is_done_act[:, None], done_leaf, S_CONTINUE), raw_status).int()

    top = instr.top_kind
    a_prior, b_prior = instr.a_succ, instr.b_succ
    a_status = _side_status(instr, leaf_status, instr.a_is_and, 0, 1, a_prior)
    b_status = _side_status(instr, leaf_status, instr.b_is_and, 2, 3, b_prior)
    is_action, is_and = top == TOP_ACTION, top == TOP_AND
    is_before, is_after = top == TOP_BEFORE, top == TOP_AFTER

    def then(first_status, first_prior, second_status):
        # BEFORE/AFTER (verifier.py:465-487, :505-527): the first side, and
        # on its success the same action drives the second.
        return torch.where(
            first_prior | (first_status == S_SUCCESS),
            torch.where(second_status == S_FAILURE, S_FAILURE, torch.where(second_status == S_SUCCESS, S_SUCCESS, S_CONTINUE)),
            torch.where(
                first_status == S_FAILURE,
                S_FAILURE,
                torch.where(instr.strict & (second_status == S_SUCCESS), S_FAILURE, S_CONTINUE),
            ),
        )

    bef_status = then(a_status, a_prior, b_status)
    aft_status = then(b_status, b_prior, a_status)
    # TOP_AND keeps its two ActionInstrs in slots 0 and 1.
    true = torch.ones_like(a_prior)
    top_and_status = _side_status(instr, leaf_status, true, 0, 1, ~true)
    status = torch.where(
        is_action, leaf_status[:, 0], torch.where(is_and, top_and_status, torch.where(is_before, bef_status, aft_status))
    )

    # Which leaves the reference calls this step (gates memory and stickies).
    a_called = torch.where(
        is_action | is_and, True, torch.where(is_before, ~a_prior, b_prior | (b_status == S_SUCCESS) | instr.strict)
    )
    b_called = torch.where(
        is_action,
        False,
        torch.where(is_and, True, torch.where(is_before, a_prior | (a_status == S_SUCCESS) | instr.strict, ~b_prior)),
    )
    called = torch.stack(
        [
            a_called & ~instr.sub_succ[:, 0],
            a_called & instr.a_is_and & ~instr.sub_succ[:, 1],
            b_called & ~instr.sub_succ[:, 2],
            b_called & instr.b_is_and & ~instr.sub_succ[:, 3],
        ],
        dim=1,
    )
    # Per-leaf memory where called (verifier.py:343-344, :411-412); in
    # done-actions mode a done action never reaches verify_action
    # (verifier.py:230-233), so neither preCarrying nor lastStepMatch moves.
    mem_update = called & ~is_done_act[:, None]
    pre_none = torch.where(mem_update, ~now_held[:, None], instr.pre_none)
    pre_move_tracked = torch.where(mem_update, instr.carried[..., 0], instr.pre_move_tracked)
    last_match = torch.where(done_mode & mem_update, raw_status == S_SUCCESS, instr.last_match)
    sub_succ = instr.sub_succ | (called & (leaf_status == S_SUCCESS))
    # A side's success latches only while that side is driven: the
    # reference never stores the second stage's result before the first
    # completes (the strict-mode peek is checked and dropped).
    a_live = is_before | (is_after & (b_prior | (b_status == S_SUCCESS)))
    b_live = is_after | (is_before & (a_prior | (a_status == S_SUCCESS)))
    instr = instr.replace(
        pre_none=pre_none,
        pre_move_tracked=pre_move_tracked,
        last_match=last_match,
        sub_succ=sub_succ,
        a_succ=instr.a_succ | (a_live & (a_status == S_SUCCESS)),
        b_succ=instr.b_succ | (b_live & (b_status == S_SUCCESS)),
    )
    return instr, status.int()


# -- construction (the levels' gen_attempt) -------------------------------------


def _set_at(x: torch.Tensor, index, value) -> torch.Tensor:
    out = x.clone()
    out[(slice(None),) + index] = torch.as_tensor(value, device=x.device).to(x.dtype)
    return out


def set_leaf(instr: InstrState, leaf: int, kind, strict=False) -> InstrState:
    return instr.replace(
        leaf_kind=_set_at(instr.leaf_kind, (leaf,), kind), leaf_strict=_set_at(instr.leaf_strict, (leaf,), strict)
    )


def set_desc(instr, leaf: int, d: int, grid, agent_pos, agent_dir, d_type, d_color=-1, d_loc=-1, agent_room_mask=None):
    """Attach descriptor (type, color, loc), ints or int32 [N], to slot
    (leaf, d) and resolve its matching objects on the finished grid (the
    reference's reset_verifier and find_matching_objs)."""
    n, device = grid.shape[0], grid.device
    d_type, d_color, d_loc = (torch.as_tensor(v, device=device).int().expand(n) for v in (d_type, d_color, d_loc))
    mask = desc_match_mask(grid, d_type, d_color, d_loc, agent_pos, agent_dir, agent_room_mask)
    bit = 1 << (leaf * 2 + d)
    packed = torch.where(mask, bit, 0).int()
    return instr.replace(
        d_type=_set_at(instr.d_type, (leaf, d), d_type),
        d_color=_set_at(instr.d_color, (leaf, d), d_color),
        d_loc=_set_at(instr.d_loc, (leaf, d), d_loc),
        d_plural=_set_at(instr.d_plural, (leaf, d), mask.flatten(1).sum(dim=1) > 1),
        gridm=(instr.gridm & ~bit) | packed,
        poss=(instr.poss & ~bit) | packed,
    )


def set_top(instr: InstrState, kind, a_is_and=False, b_is_and=False, strict=False) -> InstrState:
    """The top-level shape; TOP_AND keeps its two ActionInstrs in slots 0
    and 1 with ``a_is_and`` set, so that the called-mask covers both."""
    n, device = instr.top_kind.shape[0], instr.top_kind.device
    kind, a_is_and, b_is_and, strict = (torch.as_tensor(v, device=device).expand(n) for v in (kind, a_is_and, b_is_and, strict))
    return instr.replace(
        top_kind=kind.int().clone(),
        a_is_and=a_is_and.bool() | (kind == TOP_AND),
        b_is_and=b_is_and.bool().clone(),
        strict=strict.bool().clone(),
    )


def start_carrying_object(instr: InstrState, pos: torch.Tensor) -> InstrState:
    """The tracked objects at ``pos`` (int32 [N, 2]) moved from the grid into
    the agent's hand before the episode starts (PutNext's
    ``start_carrying``, reference putnext.py:190-200: the descriptors were
    matched with the object in the grid, then it was lifted).  ``poss``
    stays as it was, as the reference leaves ``obj_poss`` stale."""
    n, _, h = instr.gridm.shape
    idx = pos[:, 0].long() * h + pos[:, 1].long()
    word = plane_at(instr.gridm, idx)
    gridm = instr.gridm.reshape(n, -1).scatter(1, idx[:, None], torch.zeros_like(word)[:, None])
    return instr.replace(carried=instr.carried | unpack_slots(word), gridm=gridm.reshape(instr.gridm.shape))


def num_navs(instr: InstrState) -> torch.Tensor:
    """int32 [N]: navigations for the dynamic step limit (reference
    roomgrid_level.py:215-235): PutNext counts 2, other leaves 1."""
    per_leaf = torch.where(instr.leaf_kind == LEAF_PUTNEXT, 2, 1)
    return (per_leaf * (instr.leaf_kind >= 0)).sum(dim=1, dtype=torch.int32)
