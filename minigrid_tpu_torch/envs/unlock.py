"""Unlock, UnlockPickup, BlockedUnlockPickup (reference: minigrid/envs/unlock.py,
unlockpickup.py, blockedunlockpickup.py), and the RoomGrid base they share
with KeyCorridor, ObstructedMaze and BabyAI's levels.

Counterpart of ``minigrid_tpu/envs/unlock.py``.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import grid as g
from minigrid_tpu_torch.core import sampling as s_
from minigrid_tpu_torch.core.actions import Actions
from minigrid_tpu_torch.core.constants import OBJ_BALL, OBJ_BOX, OBJ_KEY, SORTED_COLOR_IDX, STATE_OPEN, cell, cell_state
from minigrid_tpu_torch.core.env import MiniGridEnv
from minigrid_tpu_torch.core.mission import mission_rows, mission_vec, template_id
from minigrid_tpu_torch.core.roomgrid import RoomGridBuilder
from minigrid_tpu_torch.core.state import EnvState, new_state
from minigrid_tpu_torch.core.step import success_reward
from minigrid_tpu_torch.ops import fused_ext as fx

_MISSION_OPEN = mission_vec(template_id("open the door"))
MISSION_PICKUP = template_id("pick up the {0} {1}", ("color", "type"))


class RoomGridEnvBase(MiniGridEnv):
    """An env on the RoomGrid lattice: its size is the lattice's, and its
    levels come from ``self.builder``."""

    expensive_reset = True

    def __init__(self, room_size: int, num_rows: int, num_cols: int, max_steps: int, **kwargs):
        builder = RoomGridBuilder(room_size, num_rows, num_cols)
        super().__init__(
            width=builder.width, height=builder.height, max_steps=max_steps, see_through_walls=False, **kwargs
        )
        self.builder = builder


class UnlockFusedExt(fx.CachedExt):
    """Unlock's step overlay (``csrc/ext/unlock.cuh``; JAX:
    ``minigrid_tpu/envs/unlock.py::_UnlockFusedExt``): a toggle after which
    the level's door is open in the post-step grid succeeds.  Extra
    scalars: the door's x and y, blended from the reset cache."""

    n_scalars = 2
    kernel_id = 7
    # Objects, a per-episode mission, occluding walls.
    kernel_switches = (False, False, False)

    def pack_extra(self, env, extra):
        return extra["door_pos"].to(torch.int32)

    def unpack_extra(self, env, scal):
        return {"door_pos": scal}

    def post_step(self, env, prev, state, action, reward, scal):
        door = g.get_cell(state.grid, scal[:, 0], scal[:, 1])
        success = (action == Actions.toggle) & (cell_state(door) == STATE_OPEN)
        return success, torch.where(success, success_reward(state.step_count, state.max_steps), reward), scal


class PickupTargetFusedExt(fx.CachedExt):
    """UnlockPickup's, BlockedUnlockPickup's and KeyCorridor's step overlay
    (``csrc/ext/pickup_target.cuh``; JAX: ``minigrid_tpu/envs/unlock.py::
    _UnlockPickupFusedExt``, ``keycorridor.py::_KeyCorridorFusedExt``): a
    pickup that leaves the agent carrying the target succeeds.  Extra
    scalar: the target's color, blended from the reset cache; its kind is
    the family's ``target_kind``, which the kernels take by value."""

    n_scalars = 1
    kernel_id = 8
    # Objects, a per-episode mission, occluding walls.
    kernel_switches = (False, False, False)

    def kernel_params(self, env) -> tuple[int, ...]:
        return (env.max_steps, 0, 0, int(env.target_kind), -1, -1, 0)

    def pack_extra(self, env, extra):
        return extra["target_color"].to(torch.int32)[..., None]

    def unpack_extra(self, env, scal):
        return {"target_color": scal[..., 0]}

    def post_step(self, env, prev, state, action, reward, scal):
        carry = state.carrying
        success = (action == Actions.pickup) & ((carry & 0xFF) == env.target_kind) & (((carry >> 8) & 0xFF) == scal[:, 0])
        return success, torch.where(success, success_reward(state.step_count, state.max_steps), reward), scal


class UnlockEnv(RoomGridEnvBase):
    """Two rooms, a locked door and its key; toggling the door open succeeds
    (reference: minigrid/envs/unlock.py:76-97)."""

    fused_ext = UnlockFusedExt()

    def __init__(self, max_steps: int | None = None, **kwargs):
        room_size = 6
        if max_steps is None:
            max_steps = 8 * room_size**2
        super().__init__(room_size, 1, 2, max_steps, **kwargs)

    def _generate(self, num_envs: int, generator: torch.Generator | None, device) -> EnvState:
        b = self.builder
        s = b.init(generator, num_envs, device)
        s, door_color, door_pos = b.add_door(generator, s, 0, 0, 0, locked=True)
        s, _, _, _ = b.add_object(generator, s, 0, 0, kind=OBJ_KEY, color=door_color)
        s = b.place_agent(generator, s, 0, 0)
        return new_state(
            s.grid, s.agent_pos, s.agent_dir, self.max_steps, mission=_MISSION_OPEN, extra={"door_pos": door_pos}
        )

    def _post_step(self, prev, state, action, reward):
        return self.fused_ext.apply_post_step(self, prev, state, action, reward)


class UnlockPickupEnv(RoomGridEnvBase):
    """A box behind a locked door; picking it up succeeds
    (reference: minigrid/envs/unlockpickup.py:60-110)."""

    blocked = False
    target_kind = OBJ_BOX
    fused_ext = PickupTargetFusedExt()

    def __init__(self, max_steps: int | None = None, **kwargs):
        room_size = 6
        if max_steps is None:
            max_steps = (16 if self.blocked else 8) * room_size**2
        super().__init__(room_size, 1, 2, max_steps, **kwargs)

    def _generate(self, num_envs: int, generator: torch.Generator | None, device) -> EnvState:
        b = self.builder
        s = b.init(generator, num_envs, device)
        s, _, box_color, _ = b.add_object(generator, s, 1, 0, kind=OBJ_BOX)
        s, door_color, door_pos = b.add_door(generator, s, 0, 0, 0, locked=True)
        if self.blocked:
            # A ball on the cell left of the door, inside room (0, 0)
            # (reference blockedunlockpickup.py:98-100).
            table = torch.tensor(SORTED_COLOR_IDX, dtype=torch.int32, device=device)
            ball_color = table[s_.randint(generator, num_envs, 0, len(SORTED_COLOR_IDX), device).long()]
            s = s.replace(grid=g.set_cell(s.grid, door_pos[:, 0] - 1, door_pos[:, 1], cell(OBJ_BALL, ball_color)))
        s, _, _, _ = b.add_object(generator, s, 0, 0, kind=OBJ_KEY, color=door_color)
        s = b.place_agent(generator, s, 0, 0)
        kind = torch.full_like(box_color, OBJ_BOX)
        return new_state(
            s.grid,
            s.agent_pos,
            s.agent_dir,
            self.max_steps,
            mission=mission_rows(MISSION_PICKUP, box_color, kind),
            extra={"target_color": box_color},
        )

    def _post_step(self, prev, state, action, reward):
        return self.fused_ext.apply_post_step(self, prev, state, action, reward)


class BlockedUnlockPickupEnv(UnlockPickupEnv):
    """UnlockPickup with a ball blocking the door
    (reference: minigrid/envs/blockedunlockpickup.py:66-120)."""

    blocked = True
