"""Frame rendering: full-grid and agent-POV RGB frames of a batch
(reference: minigrid/minigrid_env.py:652-739).

Counterpart of ``minigrid_tpu/render/frame.py``.  The cells the agent sees
come from the observation op (``core/obs.gen_obs_packed``, the observation
kernel on the card) as ``packed != 0``: no cell of a state packs to 0 (an
empty cell is 1, the carried-object override is never 0) and the agent
cell is always seen, so a nonzero packed cell is exactly a visible one.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import obs as obs_lib
from minigrid_tpu_torch.core.constants import TILE_PIXELS
from minigrid_tpu_torch.render.atlas import render_grid


def get_pov_render(state, view_size: int, see_through_walls: bool, tile_size: int) -> torch.Tensor:
    """uint8 [N, v*ts, v*ts, 3]: the agent's point of view, unseen cells
    black (reference: minigrid_env.py:652-666)."""
    packed = obs_lib.gen_obs_packed(state, view_size, see_through_walls)
    return render_grid(
        packed, tile_size, agent_pos=(view_size // 2, view_size - 1), agent_dir=3, highlight_mask=packed != 0
    )


def get_full_render(state, view_size: int, see_through_walls: bool, tile_size: int, highlight: bool) -> torch.Tensor:
    """uint8 [N, H*ts, W*ts, 3]: the whole grid, with the cells the agent
    sees highlighted (reference: minigrid_env.py:668-714)."""
    n, w, h = state.grid.shape
    hl = None
    if highlight:
        vis = obs_lib.gen_obs_packed(state, view_size, see_through_walls) != 0
        x, y = obs_lib.view_world_coords(state.agent_x, state.agent_y, state.agent_dir, view_size)
        inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
        flat = (x.clamp(0, w - 1) * h + y.clamp(0, h - 1)).long().reshape(n, -1)
        hl = torch.zeros((n, w * h), dtype=torch.int32, device=state.grid.device)
        hl = hl.scatter_reduce(1, flat, (vis & inside).int().reshape(n, -1), "amax").bool().reshape(n, w, h)
    return render_grid(
        state.grid, tile_size, agent_pos=(state.agent_x, state.agent_y), agent_dir=state.agent_dir, highlight_mask=hl
    )


def get_frame(
    state,
    view_size: int,
    see_through_walls: bool,
    highlight: bool = True,
    tile_size: int = TILE_PIXELS,
    agent_pov: bool = False,
) -> torch.Tensor:
    """uint8 RGB frames of every env (reference: minigrid_env.py:716-739)."""
    if agent_pov:
        return get_pov_render(state, view_size, see_through_walls, tile_size)
    return get_full_render(state, view_size, see_through_walls, tile_size, highlight)
