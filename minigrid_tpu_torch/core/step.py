"""Branchless batched core transition.

Same semantics as ``minigrid_tpu/core/step.py::core_step`` (the reference's
``MiniGridEnv.step``, minigrid/minigrid_env.py:525-595): every action branch
is a predicated update of per-env values.  Where the TPU version reads the
front cell with a one-hot max-reduce and writes it with a one-hot blend,
this one gathers from and scatters into the flat ``[N, W*H]`` grid.
Unknown action values are no-ops.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core.actions import Actions
from minigrid_tpu_torch.core.constants import (
    OBJ_BOX,
    OBJ_DOOR,
    OBJ_EMPTY,
    OBJ_GOAL,
    OBJ_KEY,
    OBJ_LAVA,
    STATE_LOCKED,
    STATE_OPEN,
    can_overlap,
    can_pickup,
    dir_vec,
)
from minigrid_tpu_torch.core.state import EnvState


def success_reward(step_count: torch.Tensor, max_steps: torch.Tensor) -> torch.Tensor:
    """float32 ``1 - 0.9 * (step_count / max_steps)``, rounded after each
    operation (minigrid/minigrid_env.py:240-245)."""
    return 1.0 - 0.9 * (step_count.float() / max_steps.float())


def core_step(state: EnvState, action: torch.Tensor) -> tuple[EnvState, torch.Tensor]:
    """Apply ``action`` (int32[N]) to every env; returns (state, reward f32[N]).

    ``terminated``/``truncated`` of the result describe this step only.
    """
    n, w, h = state.grid.shape
    action = action.to(torch.int32)
    step_count = state.step_count + 1

    # Front cell from the pre-action direction, clamped into the grid
    # (reference: minigrid/minigrid_env.py:534-538).
    dx, dy = dir_vec(state.agent_dir)
    fx = (state.agent_x + dx).clamp(0, w - 1)
    fy = (state.agent_y + dy).clamp(0, h - 1)
    fidx = (fx * h + fy).long()[:, None]
    grid = state.grid.reshape(n, w * h)
    contains = state.contains.reshape(n, w * h)
    fcell = grid.gather(1, fidx)[:, 0]
    fcont = contains.gather(1, fidx)[:, 0]
    ftype = fcell & 0xFF
    fcolor = (fcell >> 8) & 0xFF
    fstate = (fcell >> 16) & 0xFF

    is_fwd = action == Actions.forward
    is_toggle = action == Actions.toggle

    # -- Rotation (reference: :541-548) --
    d = state.agent_dir
    agent_dir = torch.where(
        action == Actions.left,
        (d + 3) % 4,
        torch.where(action == Actions.right, (d + 1) % 4, d),
    )

    # -- Forward movement (reference: :551-558) --
    moves = is_fwd & can_overlap(ftype, fstate)
    agent_x = torch.where(moves, fx, state.agent_x)
    agent_y = torch.where(moves, fy, state.agent_y)
    hit_goal = is_fwd & (ftype == OBJ_GOAL)
    terminated = hit_goal | (is_fwd & (ftype == OBJ_LAVA))
    reward = torch.where(hit_goal, success_reward(step_count, state.max_steps), 0.0)

    # -- Pickup, drop and toggle (reference: :561-578; doors
    #    minigrid/core/world_object.py:185-195, boxes :291-294) --
    carry = state.carrying
    hands_free = carry == 0
    do_pickup = (action == Actions.pickup) & can_pickup(ftype) & hands_free
    do_drop = (action == Actions.drop) & (ftype == OBJ_EMPTY) & ~hands_free
    has_key = ((carry & 0xFF) == OBJ_KEY) & (((carry >> 8) & 0xFF) == fcolor)
    door_new_state = torch.where(
        fstate == STATE_LOCKED,
        torch.where(has_key, STATE_OPEN, STATE_LOCKED),
        torch.where(fstate == STATE_OPEN, 1, 0),
    ).to(torch.int32)
    do_toggle_door = is_toggle & (ftype == OBJ_DOOR)
    do_toggle_box = is_toggle & (ftype == OBJ_BOX)

    # The branches are mutually exclusive.
    new_fcell = fcell
    new_fcell = torch.where(do_pickup, OBJ_EMPTY, new_fcell)
    new_fcell = torch.where(do_drop, carry & 0xFFFF, new_fcell)
    new_fcell = torch.where(do_toggle_door, (fcell & 0xFFFF) | (door_new_state << 16), new_fcell)
    new_fcell = torch.where(do_toggle_box, torch.where(fcont == 0, OBJ_EMPTY, fcont), new_fcell)
    new_fcont = fcont
    new_fcont = torch.where(do_pickup | do_toggle_box, 0, new_fcont)
    new_fcont = torch.where(do_drop, (carry >> 16) & 0xFFFF, new_fcont)

    # An unchanged front cell is written back as it was.
    grid = grid.scatter(1, fidx, new_fcell[:, None])
    contains = contains.scatter(1, fidx, new_fcont[:, None])

    picked = ftype | (fcolor << 8) | (fcont << 16)
    carrying = torch.where(do_pickup, picked, carry)
    carrying = torch.where(do_drop, 0, carrying)

    new = state.replace(
        grid=grid.reshape(n, w, h),
        contains=contains.reshape(n, w, h),
        agent_x=agent_x,
        agent_y=agent_y,
        agent_dir=agent_dir,
        carrying=carrying,
        step_count=step_count,
        terminated=terminated,
        truncated=step_count >= state.max_steps,
    )
    return new, reward
