"""Compatibility shims for external APIs (gymnasium single-env host mode)."""

from minigrid_tpu_torch.compat.gym import (
    GymnasiumMiniGrid,
    gym_make,
    register_gymnasium_envs,
)

__all__ = ["GymnasiumMiniGrid", "gym_make", "register_gymnasium_envs"]
