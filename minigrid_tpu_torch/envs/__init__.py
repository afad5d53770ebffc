"""Environment families; importing this package registers their ids
(reference registration table: minigrid/__init__.py:117-160)."""

from __future__ import annotations

from minigrid_tpu_torch.envs.empty import EmptyEnv
from minigrid_tpu_torch.registry import register

register("MiniGrid-Empty-5x5-v0", EmptyEnv, size=5)
register("MiniGrid-Empty-6x6-v0", EmptyEnv, size=6)
register("MiniGrid-Empty-8x8-v0", EmptyEnv)
register("MiniGrid-Empty-16x16-v0", EmptyEnv, size=16)

__all__ = ["EmptyEnv"]
