"""Batched environment state: a dataclass of tensors with a leading env axis.

The same fields and packed encodings as ``minigrid_tpu/core/state.py``, with
the batch written out (``[N, ...]``) where the JAX package ``vmap``s a
single-env struct.  A reset cache is the same dataclass with leaves
``[N, R, ...]``.

There is no ``rng`` field: the families this package covers draw no
randomness inside an episode (the JAX fused kernel does not thread the key
chain either, ``minigrid_tpu/ops/fused_rollout.py:17-19``); callers pass a
``torch.Generator`` where randomness is drawn.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from minigrid_tpu_torch.core.constants import pack_grid

# Width of the structured mission vector: slot 0 is a template id, the rest
# are template parameters (minigrid_tpu/core/state.py:46).
MISSION_DIM = 8


@dataclass
class EnvState:
    grid: torch.Tensor  # int32[*B, W, H] packed cells
    contains: torch.Tensor  # int32[*B, W, H] packed (type | color << 8)
    agent_x: torch.Tensor  # int32[*B]
    agent_y: torch.Tensor  # int32[*B]
    agent_dir: torch.Tensor  # int32[*B]
    carrying: torch.Tensor  # int32[*B] packed carried object
    step_count: torch.Tensor  # int32[*B]
    max_steps: torch.Tensor  # int32[*B]
    terminated: torch.Tensor  # bool[*B]
    truncated: torch.Tensor  # bool[*B]
    mission: torch.Tensor  # int32[*B, MISSION_DIM]

    def replace(self, **changes) -> EnvState:
        return dataclasses.replace(self, **changes)

    def map(self, fn) -> EnvState:
        """Apply ``fn`` to every field."""
        return EnvState(**{f: fn(getattr(self, f)) for f in FIELDS})

    @property
    def agent_pos(self) -> torch.Tensor:
        return torch.stack([self.agent_x, self.agent_y], dim=-1)

    @property
    def device(self) -> torch.device:
        return self.grid.device


FIELDS = tuple(f.name for f in dataclasses.fields(EnvState))


def select(mask: torch.Tensor, a: EnvState, b: EnvState) -> EnvState:
    """Per-env blend: ``a`` where ``mask`` (bool[N]) is set, else ``b``."""

    def pick(x, y):
        m = mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))
        return torch.where(m, x, y)

    return EnvState(**{f: pick(getattr(a, f), getattr(b, f)) for f in FIELDS})


def new_state(grid, agent_pos, agent_dir, max_steps, contains=None, mission=None):
    """Fresh batched episodes with zeroed episode counters.

    ``grid`` is packed int32[N, W, H] or the reference's uint8[N, W, H, 3]
    encoding; ``contains`` likewise packed or uint8[N, W, H, 2].  The other
    arguments are per-env tensors or values shared by every env.
    """
    if grid.dim() == 4 and grid.shape[-1] == 3:
        grid = pack_grid(grid)
    grid = grid.to(torch.int32)
    n, device = grid.shape[0], grid.device

    def per_env(value, *trailing):
        t = torch.as_tensor(value, dtype=torch.int32, device=device)
        return t.expand((n,) + trailing).contiguous()

    if contains is None:
        contains = torch.zeros_like(grid)
    elif contains.dim() == 4 and contains.shape[-1] == 2:
        c = contains.to(torch.int32)
        contains = c[..., 0] | (c[..., 1] << 8)
    pos = per_env(agent_pos, 2)
    false = torch.zeros(n, dtype=torch.bool, device=device)
    return EnvState(
        grid=grid,
        contains=contains.to(torch.int32),
        agent_x=pos[:, 0].contiguous(),
        agent_y=pos[:, 1].contiguous(),
        agent_dir=per_env(agent_dir),
        carrying=per_env(0),
        step_count=per_env(0),
        max_steps=per_env(max_steps),
        terminated=false,
        truncated=false.clone(),
        mission=per_env(0 if mission is None else mission, MISSION_DIM),
    )
