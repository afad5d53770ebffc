"""Batched packed egocentric observation: K4.

Port of ``minigrid_tpu/ops/obs_pallas.py``.  ``fused_obs_packed`` maps the
state's grid int32 [N, W, H] and its ``agent_x``, ``agent_y``,
``agent_dir`` and ``carrying`` int32 [N] to the packed int32 [N, v, v]
view in the port's [i, j] layout, 0 for unseen cells.  The CUDA kernel
(``csrc/obs_packed.cu``) replaces the Pallas kernel ``_kernel``: view
extraction, the occlusion flood, the carried object at the agent cell and
the zeroing of unseen cells in one pass, where the plain version is a
Python loop of some 200 small ops at v = 7.  The kernel takes every odd v
in ``BUILT_VIEW_SIZES`` and both values of ``see_through_walls``.

``fused_obs_packed`` dispatches on the device of ``grid``: CUDA tensors
launch the kernel (or raise), CPU tensors run
``fused_obs_packed_reference``, the plain PyTorch version
(``minigrid_tpu/core/obs.py``'s semantics, the reference's slice, rotate,
occlusion sweep and encode: minigrid/minigrid_env.py:597-650,
minigrid/core/grid.py:110-143, :291-328).  ``KERNEL_LAUNCHES`` counts the
kernel launches.

View coordinates: the agent sits at (v//2, v-1) facing "up"; view cell
(vi, vj) lies at ``agent_pos + f * (v-1-vj) - r * (v//2 - vi)`` with ``f`` the
facing vector and ``r = (-f_y, f_x)``.
"""

from __future__ import annotations

import ctypes

import torch

from minigrid_tpu_torch.core.constants import OBJ_EMPTY, WALL_CELL, cell_state, cell_type, dir_vec, see_behind
from minigrid_tpu_torch.ops._build import load_library

# View sizes the CUDA source takes (csrc/obs_packed.cu): every odd v from 3
# to 15 instantiated, 17 to 31 at run time.  31 is the widest view whose
# rows fit the flood's 32-bit masks, as in the JAX package, whose int32
# masks overflow past it.
BUILT_VIEW_SIZES = tuple(range(3, 32, 2))
# Launches of the CUDA kernel since import (or since a caller reset it).
KERNEL_LAUNCHES = 0

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def view_world_coords(agent_x, agent_y, agent_dir, view_size: int):
    """int32[N, v, v] world x and y of each view cell (may lie outside)."""
    v = view_size
    fx, fy = dir_vec(agent_dir)
    rx, ry = -fy, fx
    k = torch.arange(v, dtype=torch.int32, device=agent_x.device)
    ahead = (v - 1 - k)[None, None, :]  # by view row vj
    left = (v // 2 - k)[None, :, None]  # by view column vi
    ax, ay, fx, fy, rx, ry = (t[:, None, None] for t in (agent_x, agent_y, fx, fy, rx, ry))
    return ax + fx * ahead - rx * left, ay + fy * ahead - ry * left


def extract_view(grid: torch.Tensor, agent_x, agent_y, agent_dir, view_size: int):
    """Packed int32[N, v, v] agent-frame view; cells outside the grid read as
    walls (reference ``Grid.slice``, minigrid/core/grid.py:136-141)."""
    n, w, h = grid.shape
    wx, wy = view_world_coords(agent_x, agent_y, agent_dir, view_size)
    inside = (wx >= 0) & (wx < w) & (wy >= 0) & (wy < h)
    idx = (wx.clamp(0, w - 1) * h + wy.clamp(0, h - 1)).long().reshape(n, -1)
    cells = grid.reshape(n, w * h).gather(1, idx).reshape(wx.shape)
    return torch.where(inside, cells, WALL_CELL)


def process_vis(trans: torch.Tensor) -> torch.Tensor:
    """bool[N, v, v] visibility of a transparency view indexed [column, row].

    The reference's two-way bottom-up sweep (minigrid/core/grid.py:291-328)
    as the JAX package's bit-parallel flood: light floods right in closed
    carry form ``m | (((m & t) + t) ^ t)``, left by v-1 single spreads, and
    each lit transparent cell lights its three upward neighbours.  The
    masks stay below ``2**v``, so torch's arithmetic ``>>`` on int32 is
    exact.
    """
    v = trans.shape[-1]
    full = (1 << v) - 1
    weights = (1 << torch.arange(v, dtype=torch.int32, device=trans.device))[:, None]
    row_t = (trans.int() * weights).sum(dim=1, dtype=torch.int32)  # [N, v] by row

    up = torch.full_like(row_t[:, 0], 1 << (v // 2))  # agent-row seed
    rows = [None] * v
    for j in range(v - 1, -1, -1):
        t = row_t[:, j]
        m_r = up | ((((up & t) + t) & full) ^ t)
        cond_r = m_r & t & ((1 << (v - 1)) - 1)
        new_up = cond_r | ((cond_r << 1) & full)
        m_l = m_r
        for _ in range(v - 1):
            m_l = m_l | ((m_l & t) >> 1)
        cond_l = m_l & t & ~1
        rows[j] = m_l
        up = new_up | cond_l | (cond_l >> 1)
    bits = torch.stack(rows, dim=1)  # [N, v] by row j
    shifts = torch.arange(v, dtype=torch.int32, device=trans.device)[:, None]
    return ((bits[:, None, :] >> shifts) & 1).bool()  # [N, i, j]


def view_and_vis_packed(grid, agent_x, agent_y, agent_dir, carrying, view_size: int, see_through_walls: bool):
    """Packed int32[N, v, v] view with the carried object (or empty) at the
    agent cell, and its bool[N, v, v] visibility, which is computed from the
    cells as they lie in the grid."""
    v = view_size
    cells = extract_view(grid, agent_x, agent_y, agent_dir, v)
    if see_through_walls:
        vis = torch.ones_like(cells, dtype=torch.bool)
    else:
        vis = process_vis(see_behind(cell_type(cells), cell_state(cells)))
    # Reference: minigrid/minigrid_env.py:623-630.
    cells[:, v // 2, v - 1] = torch.where(carrying != 0, carrying & 0xFFFF, OBJ_EMPTY)
    return cells, vis


def fused_obs_packed_reference(
    grid, agent_x, agent_y, agent_dir, carrying, view_size: int = 7, see_through_walls: bool = False
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device."""
    cells, vis = view_and_vis_packed(grid, agent_x, agent_y, agent_dir, carrying, view_size, see_through_walls)
    return torch.where(vis, cells, 0)


def fused_obs_packed(
    grid, agent_x, agent_y, agent_dir, carrying, view_size: int = 7, see_through_walls: bool = False
) -> torch.Tensor:
    """Packed int32[N, v, v] observation of a batch: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if grid.device.type == "cpu":
        return fused_obs_packed_reference(grid, agent_x, agent_y, agent_dir, carrying, view_size, see_through_walls)
    return _launch(grid, agent_x, agent_y, agent_dir, carrying, view_size, see_through_walls)


def _require(cond: bool, message: str) -> None:
    if not cond:
        raise ValueError(f"obs_packed kernel: {message}")


def _launch(grid, agent_x, agent_y, agent_dir, carrying, view_size: int, see_through_walls: bool) -> torch.Tensor:
    global KERNEL_LAUNCHES
    _require(grid.device.type == "cuda", f"grid on {grid.device}, need CUDA (or CPU for the plain version)")
    _require(view_size in BUILT_VIEW_SIZES, f"view size {view_size} was not built (built: {BUILT_VIEW_SIZES})")
    _require(grid.dim() == 3, f"grid must be [N, W, H], got {tuple(grid.shape)}")
    n, w, h = grid.shape
    scalars = (agent_x, agent_y, agent_dir, carrying)
    for name, t in zip(("agent_x", "agent_y", "agent_dir", "carrying", "grid"), (*scalars, grid)):
        _require(t.dtype == torch.int32, f"{name} must be int32, got {t.dtype}")
        _require(t.device == grid.device, f"{name} on {t.device}, grid on {grid.device}")
        if t is not grid:
            _require(t.shape == (n,), f"{name} must be [{n}], got {tuple(t.shape)}")
    grid, ax, ay, d, carry = (t.contiguous() for t in (grid, *scalars))
    out = torch.empty((n, view_size, view_size), dtype=torch.int32, device=grid.device)
    fn = load_library("obs_packed").obs_packed_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream(grid.device).cuda_stream
        err = fn(
            grid.data_ptr(), ax.data_ptr(), ay.data_ptr(), d.data_ptr(), carry.data_ptr(), out.data_ptr(),
            n, w, h, view_size, int(see_through_walls), stream,
        )
    if err != 0:
        raise RuntimeError(f"obs_packed kernel launch failed with CUDA error {err}")
    KERNEL_LAUNCHES += 1
    return out
