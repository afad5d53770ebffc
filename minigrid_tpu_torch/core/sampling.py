"""Placement and integer sampling for batched level generators.

Counterpart of ``minigrid_tpu/core/sampling.py``.  The reference places an
object by rejection: uniform cells of a rectangle until a free one comes up
(minigrid/minigrid_env.py:313-372).  Conditioned on acceptance that is the
uniform distribution over the free cells of the rectangle, so each env draws
it in one step: a uniform rank among its set cells, then the cell of that
rank.  Every draw comes from the caller's ``torch.Generator`` (on the
tensors' device), one row per env; the port cannot replay ``jax.random``,
so generators are held to the JAX package's by distribution.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core.grid import coord_grids, free_mask, rect_mask


def _span(low, high):
    """``high - low``, at least 1 (an empty range draws ``low``, as
    ``jax.random.randint`` does)."""
    d = high - low
    return d.clamp(min=1) if isinstance(d, torch.Tensor) else max(d, 1)


def randint(generator: torch.Generator | None, n: int, low, high, device=None) -> torch.Tensor:
    """int32[n], each uniform in [low, high) (the reference's ``_rand_int``,
    minigrid/minigrid_env.py:247-252).  ``low`` and ``high`` are ints or
    int32[n] tensors, since ``torch.randint`` takes no tensor bounds: the
    draw is ``low + floor(u * (high - low))`` with u a uniform 32-bit word
    over 2^32, which is exact for every range a grid has (bias below
    2^-22 for spans under 1024)."""
    device = high.device if isinstance(high, torch.Tensor) else low.device if isinstance(low, torch.Tensor) else device
    bits = torch.randint(0, 2**32, (n,), generator=generator, device=device, dtype=torch.int64)
    span = torch.as_tensor(_span(low, high), device=device).to(torch.int64)
    return (torch.as_tensor(low, device=device).to(torch.int64) + ((bits * span) >> 32)).to(torch.int32)


def rand_dir(generator: torch.Generator | None, n: int, device=None) -> torch.Tensor:
    """int32[n] uniform directions."""
    return randint(generator, n, 0, 4, device)


def masked_uniform_index(generator: torch.Generator | None, flat_mask: torch.Tensor) -> torch.Tensor:
    """Per row of bool[N, C] ``flat_mask``, a uniform index among its set
    entries (int64[N]): a uniform rank r in [0, count), then the entry
    whose running count is r + 1.  A row with no set entry gives index 0,
    as in the JAX package (callers make the placement feasible, as the
    reference's rejection loop must end).  The running count is int32, half
    the bytes of an int64 scan over a large reset cache."""
    count = flat_mask.sum(dim=1, dtype=torch.int32)
    r = randint(generator, flat_mask.shape[0], 0, count.clamp(min=1))
    rank = flat_mask.cumsum(dim=1, dtype=torch.int32) - 1
    return (flat_mask & (rank == r[:, None])).to(torch.uint8).argmax(dim=1)


def sample_mask_cell(generator: torch.Generator | None, mask: torch.Tensor) -> torch.Tensor:
    """A uniform set cell of each env's bool[N, W, H] ``mask``, as int32
    [N, 2] (x, y); (0, 0) where the mask is empty."""
    n, _, height = mask.shape
    idx = masked_uniform_index(generator, mask.reshape(n, -1))
    return torch.stack([idx // height, idx % height], dim=-1).to(torch.int32)


def place_obj_pos(
    generator: torch.Generator | None,
    grid: torch.Tensor,
    agent_pos: torch.Tensor | None = None,
    top=None,
    size=None,
    reject: torch.Tensor | None = None,
) -> torch.Tensor:
    """A placement per env with the acceptance rule of the reference's
    ``place_obj`` (minigrid/minigrid_env.py:339-364): inside the rectangle
    [top, top+size), on an empty cell, not under the agent (int32 [N, 2])
    and not where ``reject`` (bool [N, W, H]) is set.  ``top`` and ``size``
    are pairs of ints or int32[N] tensors.  Returns int32 [N, 2]."""
    _, width, height = grid.shape
    m = free_mask(grid, agent_pos)
    if top is not None or size is not None:
        t = (0, 0) if top is None else top
        s = (width, height) if size is None else size
        tx, ty = (v.clamp(min=0) if isinstance(v, torch.Tensor) else max(v, 0) for v in t)
        m = m & rect_mask(width, height, tx, ty, s[0], s[1], grid.device)
    if reject is not None:
        m = m & ~reject
    return sample_mask_cell(generator, m)


def neighbor_mask(width: int, height: int, pos: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """bool [N, W, H] mask of the (2r+1)^2 box centred on each env's
    ``pos`` (int32 [N, 2])."""
    xs, ys = coord_grids(width, height, pos.device)
    px, py = pos[:, 0, None, None], pos[:, 1, None, None]
    return (xs >= px - radius) & (xs <= px + radius) & (ys >= py - radius) & (ys <= py + radius)
