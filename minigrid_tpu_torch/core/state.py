"""Batched environment state: a dataclass of tensors with a leading env axis.

The same fields and packed encodings as ``minigrid_tpu/core/state.py``, with
the batch written out (``[N, ...]``) where the JAX package ``vmap``s a
single-env struct.  A reset cache is the same dataclass with leaves
``[N, R, ...]``.

There is no ``rng`` field: randomness inside an episode comes from a
counter-based stream seeded per episode (``ops/prng.py``, carried in
``extra`` by the families that draw it), as in the JAX fused kernel
(``minigrid_tpu/ops/fused_rollout.py:17-19``); callers pass a
``torch.Generator`` where randomness is drawn.

``extra`` holds a family's own state (Dynamic-Obstacles' obstacle
positions, say) as a dict of tensors with the same leading batch axes, or
None; a value may also be a dataclass of such tensors (BabyAI's
``InstrState``).  ``FIELDS`` lists the 11 fixed fields; ``map`` and
``select`` carry ``extra`` beside them, leaf by leaf (``tree_map``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from minigrid_tpu_torch.core.constants import pack_grid

# Width of the structured mission vector: slot 0 is a template id, the rest
# are template parameters (minigrid_tpu/core/state.py:46).  BabyAI's
# missions are wider (envs/babyai/core/text.py); a state's mission width is
# its tensor's last axis.
MISSION_DIM = 8


def tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of ``tree`` (a tensor, a tuple, dict or
    dataclass of trees, or None) and the matching leaves of ``rest``, which
    have the same structure; the same structure back."""
    if tree is None or isinstance(tree, torch.Tensor):
        return None if tree is None else fn(tree, *rest)
    if type(tree) is tuple:
        return tuple(tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(
            tree,
            **{
                f.name: tree_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
                for f in dataclasses.fields(tree)
            },
        )
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def tree_leaves(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(dotted path, tensor) of every leaf of ``tree``, dict keys in sorted
    order, so that two trees of one structure list their leaves alike."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if type(tree) is tuple:
        items = ((str(i), t) for i, t in enumerate(tree))
    elif isinstance(tree, dict):
        items = sorted(tree.items())
    else:
        items = ((f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree))
    return [leaf for k, v in items for leaf in tree_leaves(v, f"{prefix}.{k}" if prefix else k)]


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
    extra: dict[str, torch.Tensor] | None = None  # family state, leaves [*B, ...]

    def replace(self, **changes) -> EnvState:
        return dataclasses.replace(self, **changes)

    def map(self, fn) -> EnvState:
        """Apply ``fn`` to every field and every ``extra`` leaf."""
        return tree_map(fn, self)

    @property
    def agent_pos(self) -> torch.Tensor:
        return torch.stack([self.agent_x, self.agent_y], dim=-1)

    @property
    def device(self) -> torch.device:
        return self.grid.device


FIELDS = tuple(f.name for f in dataclasses.fields(EnvState) if f.name != "extra")


def resolve_device(generator: torch.Generator | None, device=None) -> torch.device:
    """The device of an entry point's new tensors: ``device`` if given, else
    the generator's, else CUDA.  A caller that wants the CPU says so."""
    if device is not None:
        return torch.device(device)
    if generator is not None:
        return generator.device
    return torch.device("cuda")


def select(mask: torch.Tensor, a: EnvState, b: EnvState) -> EnvState:
    """Per-env blend: ``a`` where ``mask`` (bool[N]) is set, else ``b``
    (``extra`` too: both have it or neither)."""

    def pick(x, y):
        m = mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))
        return torch.where(m, x, y)

    if (a.extra is None) != (b.extra is None):
        raise ValueError("select: one state has extra and the other has not")
    return tree_map(pick, a, b)


def per_env_mission(mission, n: int, device) -> torch.Tensor:
    """int32 [N, M] mission rows: ``mission`` as given where it is already
    [N, M], else broadcast to [N, MISSION_DIM]."""
    t = torch.as_tensor(mission, dtype=torch.int32, device=device)
    if t.dim() == 2:
        return t.contiguous()
    return t.expand((n, MISSION_DIM)).contiguous()


def new_state(grid, agent_pos, agent_dir, max_steps, contains=None, mission=None, extra=None):
    """Fresh batched episodes with zeroed episode counters.

    ``grid`` is packed int32[N, W, H] or the reference's uint8[N, W, H, 3]
    encoding; ``contains`` likewise packed or uint8[N, W, H, 2].  The other
    arguments are per-env tensors or values shared by every env; ``extra``
    is the family's state, leaves [N, ...].  ``mission`` is a template id
    (or a ``MISSION_DIM`` vector) shared by every env, or per-env rows
    [N, M] of any width M.
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
        mission=per_env_mission(0 if mission is None else mission, n, device),
        extra=extra,
    )
