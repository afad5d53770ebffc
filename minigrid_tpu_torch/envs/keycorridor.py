"""KeyCorridor (reference: minigrid/envs/keycorridor.py:8-137).

Counterpart of ``minigrid_tpu/envs/keycorridor.py``.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import sampling as s_
from minigrid_tpu_torch.core.constants import OBJ_BALL, OBJ_KEY
from minigrid_tpu_torch.core.mission import mission_rows
from minigrid_tpu_torch.core.state import EnvState, new_state
from minigrid_tpu_torch.envs.unlock import MISSION_PICKUP, PickupTargetFusedExt, RoomGridEnvBase


class KeyCorridorEnv(RoomGridEnvBase):
    """Three columns of rooms, the middle column joined into a corridor; the
    target object behind a locked door on the right, its key on the left
    (reference: minigrid/envs/keycorridor.py:104-137).  Picking the target
    up succeeds (``PickupTargetFusedExt`` with this family's kind)."""

    fused_ext = PickupTargetFusedExt()

    def __init__(
        self,
        room_size: int = 6,
        num_rows: int = 3,
        obj_type: str = "ball",
        max_steps: int | None = None,
        **kwargs,
    ):
        if max_steps is None:
            max_steps = 30 * room_size**2
        super().__init__(room_size, num_rows, 3, max_steps, **kwargs)
        self.obj_kind = {"ball": OBJ_BALL, "key": OBJ_KEY}[obj_type]

    @property
    def target_kind(self) -> int:
        return self.obj_kind

    def _generate(self, num_envs: int, generator: torch.Generator | None, device) -> EnvState:
        b, n = self.builder, num_envs
        s = b.init(generator, n, device)
        # Join the middle column into a corridor (reference :106-108).
        for j in range(1, b.num_rows):
            s = b.remove_wall(s, 1, j, 3)
        # A locked door and the target in a random right-column room (:110-113).
        room = s_.randint(generator, n, 0, b.num_rows, device)
        s, door_color, _ = b.add_door(generator, s, 2, room, 2, locked=True)
        s, _, obj_color, _ = b.add_object(generator, s, 2, room, kind=self.obj_kind)
        # The key in a random left-column room (:116).
        key_room = s_.randint(generator, n, 0, b.num_rows, device)
        s, _, _, _ = b.add_object(generator, s, 0, key_room, kind=OBJ_KEY, color=door_color)
        s = b.place_agent(generator, s, 1, b.num_rows // 2)
        s = b.connect_all(generator, s)
        return new_state(
            s.grid,
            s.agent_pos,
            s.agent_dir,
            self.max_steps,
            mission=mission_rows(MISSION_PICKUP, obj_color, torch.full_like(obj_color, self.obj_kind)),
            extra={"target_color": obj_color},
        )

    def _post_step(self, prev, state, action, reward):
        return self.fused_ext.apply_post_step(self, prev, state, action, reward)
