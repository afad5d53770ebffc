"""minigrid_tpu_torch — the PyTorch and CUDA port of ``minigrid_tpu``.

Batched environment state is a dataclass of tensors with a leading env axis;
the whole-rollout kernel is CUDA C++ for Hopper (``ops/csrc``), built with
``nvcc`` on first use.  ``minigrid_tpu`` (JAX) is the reference the port is
tested against; this package never imports it.
"""

from __future__ import annotations

from minigrid_tpu_torch.core.actions import Actions
from minigrid_tpu_torch.core.env import MiniGridEnv
from minigrid_tpu_torch.core.mission import MissionSpace
from minigrid_tpu_torch.core.state import EnvState
from minigrid_tpu_torch.registry import make, register, registered_ids

from minigrid_tpu_torch import envs as _envs  # noqa: F401  (populates the registry)

__all__ = ["Actions", "EnvState", "MiniGridEnv", "MissionSpace", "make", "register", "registered_ids"]
