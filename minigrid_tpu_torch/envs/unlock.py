"""The base of the RoomGrid families (reference: minigrid/envs/unlock.py,
unlockpickup.py, blockedunlockpickup.py).

Counterpart of ``minigrid_tpu/envs/unlock.py:33-47``: only
``RoomGridEnvBase``, which BabyAI's levels build on; the Unlock ids and
their step overlays are still to port (ROADMAP.md queue 1).
"""

from __future__ import annotations

from minigrid_tpu_torch.core.env import MiniGridEnv
from minigrid_tpu_torch.core.roomgrid import RoomGridBuilder


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
