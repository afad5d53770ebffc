"""Grid construction and access on batched packed grids int32[N, W, H].

Counterpart of ``minigrid_tpu/core/grid.py`` (the reference's mutable
``Grid``, minigrid/core/grid.py:20-143).  Coordinates, sizes and bounds are
ints shared by every env or int32[N] tensors (DoorKey's split column, say,
differs per env); reads are gathers and writes masked blends.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core.constants import EMPTY_CELL, OBJ_EMPTY, WALL_CELL, cell_type
from minigrid_tpu_torch.core.state import resolve_device


def coord_grids(width: int, height: int, device=None):
    """int32 x and y coordinates of a [W, H] grid, as [W, 1] and [1, H]
    tensors that broadcast against it."""
    xs = torch.arange(width, dtype=torch.int32, device=device)[:, None]
    ys = torch.arange(height, dtype=torch.int32, device=device)[None, :]
    return xs, ys


def _coords(grid: torch.Tensor):
    """int32 x and y coordinates, broadcastable against ``grid``."""
    w, h = grid.shape[-2:]
    return coord_grids(w, h, grid.device)


def _per_env(v):
    """An int, or an int32[N] tensor shaped to broadcast over [N, W, H]."""
    return v[:, None, None] if isinstance(v, torch.Tensor) else v


def _device_of(*values, device=None):
    """The device of the first tensor among ``values``, else ``device``."""
    for v in values:
        if isinstance(v, torch.Tensor):
            return v.device
    return device


def empty_grid(n: int, width: int, height: int, device=None) -> torch.Tensor:
    """All-empty packed int32[N, W, H] grids, on CUDA unless ``device`` says
    otherwise."""
    return torch.full((n, width, height), EMPTY_CELL, dtype=torch.int32, device=resolve_device(None, device))


def put(grid: torch.Tensor, mask: torch.Tensor, cell_value) -> torch.Tensor:
    """Write packed ``cell_value`` (int or int32[N]) wherever ``mask``
    ([W, H] or [N, W, H]) is set."""
    return torch.where(mask, _per_env(cell_value), grid)


def rect_mask(width: int, height: int, x0, y0, w, h, device=None) -> torch.Tensor:
    """bool mask of the rectangle [x0, x0+w) x [y0, y0+h): [W, H] where
    every bound is an int, [N, W, H] where one is an int32[N] tensor (a
    bound that differs per env)."""
    xs, ys = coord_grids(width, height, _device_of(x0, y0, w, h, device=device))
    x0, y0, w, h = (_per_env(v) for v in (x0, y0, w, h))
    return (xs >= x0) & (xs < x0 + w) & (ys >= y0) & (ys < y0 + h)


def horz_wall_mask(width: int, height: int, x, y, length=None, device=None) -> torch.Tensor:
    """A horizontal run of cells from (x, y), by default to the right edge
    (the reference's ``Grid.horz_wall``, minigrid/core/grid.py:80-90)."""
    if length is None:
        length = width - x
    return rect_mask(width, height, x, y, length, 1, device)


def vert_wall_mask(width: int, height: int, x, y, length=None, device=None) -> torch.Tensor:
    """A vertical run of cells from (x, y), by default to the bottom edge
    (minigrid/core/grid.py:92-102)."""
    if length is None:
        length = height - y
    return rect_mask(width, height, x, y, 1, length, device)


def wall_rect(grid: torch.Tensor, x: int, y: int, w: int, h: int) -> torch.Tensor:
    """Draw the one-cell-thick wall outline of a rectangle
    (reference: minigrid/core/grid.py:104-108)."""
    xs, ys = _coords(grid)
    outer = (xs >= x) & (xs < x + w) & (ys >= y) & (ys < y + h)
    inner = (xs >= x + 1) & (xs < x + w - 1) & (ys >= y + 1) & (ys < y + h - 1)
    return torch.where(outer & ~inner, WALL_CELL, grid)


def cell_mask(grid: torch.Tensor, x, y) -> torch.Tensor:
    """One-hot bool[N, W, H] mask of cell (x, y) of every env."""
    xs, ys = _coords(grid)
    return (xs == _per_env(x)) & (ys == _per_env(y))


def set_cell(grid: torch.Tensor, x, y, value) -> torch.Tensor:
    """Write packed ``value`` (int or int32[N]) at (x, y) of every env."""
    return torch.where(cell_mask(grid, x, y), _per_env(value), grid)


def get_cell(grid: torch.Tensor, x, y) -> torch.Tensor:
    """int32[N] packed cell at (x, y) of every env."""
    n, w, h = grid.shape
    idx = torch.as_tensor(x * h + y, dtype=torch.int64, device=grid.device).expand(n)
    return grid.reshape(n, w * h).gather(1, idx[:, None])[:, 0]


def free_mask(grid: torch.Tensor, agent_pos=None) -> torch.Tensor:
    """Cells that are empty and, optionally, not under the agent — the
    acceptance rule of the reference's ``place_obj``
    (minigrid/minigrid_env.py:339-364).  ``agent_pos`` is int32[N, 2]."""
    m = cell_type(grid) == OBJ_EMPTY
    if agent_pos is not None:
        m = m & ~cell_mask(grid, agent_pos[..., 0], agent_pos[..., 1])
    return m
