"""Batched egocentric observation.

Same semantics as ``minigrid_tpu/core/obs.py`` (the reference's slice, rotate,
occlusion sweep and encode: minigrid/minigrid_env.py:597-650,
minigrid/core/grid.py:110-143, :291-328).  The view is one gather of the
flat grid at the view's world coordinates, and the occlusion sweep is the
same bit-parallel flood: each view row packs into one int32 per env.  The
masks stay below ``2**v``, so torch's arithmetic ``>>`` on int32 is exact.

View coordinates: the agent sits at (v//2, v-1) facing "up"; view cell
(vi, vj) lies at ``agent_pos + f * (v-1-vj) - r * (v//2 - vi)`` with ``f`` the
facing vector and ``r = (-f_y, f_x)``.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core.constants import (
    OBJ_EMPTY,
    WALL_CELL,
    cell_state,
    cell_type,
    dir_vec,
    see_behind,
    unpack_grid,
)
from minigrid_tpu_torch.core.state import EnvState


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
    each lit transparent cell lights its three upward neighbours.
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


def view_and_vis(state: EnvState, view_size: int, see_through_walls: bool):
    """Packed int32[N, v, v] view with the carried object (or empty) at the
    agent cell, and its bool[N, v, v] visibility."""
    v = view_size
    cells = extract_view(state.grid, state.agent_x, state.agent_y, state.agent_dir, v)
    if see_through_walls:
        vis = torch.ones_like(cells, dtype=torch.bool)
    else:
        vis = process_vis(see_behind(cell_type(cells), cell_state(cells)))
    # Reference: minigrid/minigrid_env.py:623-630.
    carry = state.carrying
    cells[:, v // 2, v - 1] = torch.where(carry != 0, carry & 0xFFFF, OBJ_EMPTY)
    return cells, vis


def gen_obs_packed(state: EnvState, view_size: int, see_through_walls: bool):
    """int32[N, v, v] packed observation; invisible cells are 0 ("unseen")."""
    cells, vis = view_and_vis(state, view_size, see_through_walls)
    return torch.where(vis, cells, 0)


def gen_obs_image(state: EnvState, view_size: int, see_through_walls: bool):
    """uint8[N, v, v, 3] encoded observation (minigrid/minigrid_env.py:597-650)."""
    return unpack_grid(gen_obs_packed(state, view_size, see_through_walls))


def gen_obs(state: EnvState, view_size: int, see_through_walls: bool):
    """Observation dict of every env."""
    return {
        "image": gen_obs_image(state, view_size, see_through_walls),
        "direction": state.agent_dir,
        "mission": state.mission,
    }
