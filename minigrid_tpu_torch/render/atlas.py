"""Tile-atlas renderer, batched over the leading env axis.

Counterpart of ``minigrid_tpu/render/atlas.py``.  The reference rasterizes
each tile with per-pixel Python predicate loops and memoizes them in a dict
cache (reference: minigrid/core/grid.py:145-198,
minigrid/utils/rendering.py:8-133).  Here every possible tile appearance,
(object type, color, door state, agent direction overlay, highlight), is
rasterized once with vectorized numpy into a dense atlas, moved to a device
once per tile size, and a batch of frames is one gather of atlas tiles.

The rasterization reproduces the reference's pixel math exactly: predicates
evaluated at pixel centers of a 3x supersampled tile, float mean downsample,
uint8 truncation on write, 0.30-alpha white highlight blend.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from minigrid_tpu_torch.core.constants import (
    COLORS_RGB,
    OBJ_BALL,
    OBJ_BOX,
    OBJ_DOOR,
    OBJ_FLOOR,
    OBJ_GOAL,
    OBJ_KEY,
    OBJ_LAVA,
    OBJ_WALL,
    TILE_PIXELS,
    cell_color,
    cell_state,
    cell_type,
)

# -- vectorized predicate rasterizers (reference: utils/rendering.py:25-123) --


def _coords(n: int):
    c = (np.arange(n) + 0.5) / n
    return np.meshgrid(c, c, indexing="xy")  # xf[y, x], yf[y, x]


def _rect(xf, yf, xmin, xmax, ymin, ymax):
    return (xf >= xmin) & (xf <= xmax) & (yf >= ymin) & (yf <= ymax)


def _circle(xf, yf, cx, cy, r):
    return (xf - cx) ** 2 + (yf - cy) ** 2 <= r * r


def _line(xf, yf, x0, y0, x1, y1, r):
    p0 = np.array([x0, y0])
    d = np.array([x1, y1]) - p0
    dist = np.linalg.norm(d)
    d = d / dist
    a = np.clip((xf - x0) * d[0] + (yf - y0) * d[1], 0, dist)
    px = x0 + a * d[0]
    py = y0 + a * d[1]
    return (xf - px) ** 2 + (yf - py) ** 2 <= r * r


def _triangle(xf, yf, a, b, c):
    a, b, c = map(np.asarray, (a, b, c))
    v0, v1 = c - a, b - a
    v2x, v2y = xf - a[0], yf - a[1]
    dot00 = v0 @ v0
    dot01 = v0 @ v1
    dot11 = v1 @ v1
    dot02 = v0[0] * v2x + v0[1] * v2y
    dot12 = v1[0] * v2x + v1[1] * v2y
    inv = 1.0 / (dot00 * dot11 - dot01 * dot01)
    u = (dot11 * dot02 - dot01 * dot12) * inv
    v = (dot00 * dot12 - dot01 * dot02) * inv
    return (u >= 0) & (v >= 0) & (u + v < 1)


def _rotate(xf, yf, cx, cy, theta):
    """Inverse-rotate coordinates (reference rotate_fn, rendering.py:40-50)."""
    x = xf - cx
    y = yf - cy
    x2 = cx + x * np.cos(-theta) - y * np.sin(-theta)
    y2 = cy + y * np.cos(-theta) + x * np.sin(-theta)
    return x2, y2


def _fill(img, mask, color):
    img[mask] = np.asarray(color, np.float64).clip(0, 255).astype(np.uint8)


def _draw_object(img, xf, yf, obj_type, color_idx, state):
    c = COLORS_RGB[color_idx].astype(np.float64)
    if obj_type == OBJ_GOAL:
        _fill(img, _rect(xf, yf, 0, 1, 0, 1), c)
    elif obj_type == OBJ_FLOOR:
        # Pale color (reference: world_object.py:132-135).
        _fill(img, _rect(xf, yf, 0.031, 1, 0.031, 1), c / 2)
    elif obj_type == OBJ_LAVA:
        _fill(img, _rect(xf, yf, 0, 1, 0, 1), (255, 128, 0))
        for i in range(3):
            ylo, yhi = 0.3 + 0.2 * i, 0.4 + 0.2 * i
            for x0, y0, x1, y1 in (
                (0.1, ylo, 0.3, yhi),
                (0.3, yhi, 0.5, ylo),
                (0.5, ylo, 0.7, yhi),
                (0.7, yhi, 0.9, ylo),
            ):
                _fill(img, _line(xf, yf, x0, y0, x1, y1, 0.03), (0, 0, 0))
    elif obj_type == OBJ_WALL:
        _fill(img, _rect(xf, yf, 0, 1, 0, 1), c)
    elif obj_type == OBJ_DOOR:
        if state == 0:  # open
            _fill(img, _rect(xf, yf, 0.88, 1.00, 0.00, 1.00), c)
            _fill(img, _rect(xf, yf, 0.92, 0.96, 0.04, 0.96), (0, 0, 0))
        elif state == 2:  # locked
            _fill(img, _rect(xf, yf, 0.00, 1.00, 0.00, 1.00), c)
            _fill(img, _rect(xf, yf, 0.06, 0.94, 0.06, 0.94), 0.45 * c)
            _fill(img, _rect(xf, yf, 0.52, 0.75, 0.50, 0.56), c)
        else:  # closed
            _fill(img, _rect(xf, yf, 0.00, 1.00, 0.00, 1.00), c)
            _fill(img, _rect(xf, yf, 0.04, 0.96, 0.04, 0.96), (0, 0, 0))
            _fill(img, _rect(xf, yf, 0.08, 0.92, 0.08, 0.92), c)
            _fill(img, _rect(xf, yf, 0.12, 0.88, 0.12, 0.88), (0, 0, 0))
            _fill(img, _circle(xf, yf, 0.75, 0.50, 0.08), c)
    elif obj_type == OBJ_KEY:
        _fill(img, _rect(xf, yf, 0.50, 0.63, 0.31, 0.88), c)
        _fill(img, _rect(xf, yf, 0.38, 0.50, 0.59, 0.66), c)
        _fill(img, _rect(xf, yf, 0.38, 0.50, 0.81, 0.88), c)
        _fill(img, _circle(xf, yf, 0.56, 0.28, 0.190), c)
        _fill(img, _circle(xf, yf, 0.56, 0.28, 0.064), (0, 0, 0))
    elif obj_type == OBJ_BALL:
        _fill(img, _circle(xf, yf, 0.5, 0.5, 0.31), c)
    elif obj_type == OBJ_BOX:
        _fill(img, _rect(xf, yf, 0.12, 0.88, 0.12, 0.88), c)
        _fill(img, _rect(xf, yf, 0.18, 0.82, 0.18, 0.82), (0, 0, 0))
        _fill(img, _rect(xf, yf, 0.16, 0.84, 0.47, 0.53), c)
    # OBJ_UNSEEN / OBJ_EMPTY: nothing drawn.


def _render_tile(obj_type, color_idx, state, agent_dir, highlight, tile_size, subdivs=3):
    n = tile_size * subdivs
    img = np.zeros((n, n, 3), np.uint8)
    xf, yf = _coords(n)
    # Grid lines (reference: grid.py:169-171).
    _fill(img, _rect(xf, yf, 0, 0.031, 0, 1), (100, 100, 100))
    _fill(img, _rect(xf, yf, 0, 1, 0, 0.031), (100, 100, 100))
    _draw_object(img, xf, yf, obj_type, color_idx, state)
    if agent_dir >= 0:
        x2, y2 = _rotate(xf, yf, 0.5, 0.5, 0.5 * np.pi * agent_dir)
        tri = _triangle(x2, y2, (0.12, 0.19), (0.87, 0.50), (0.12, 0.81))
        _fill(img, tri, (255, 0, 0))
    if highlight:
        # reference highlight_img (rendering.py:126-133).
        blend = img + 0.30 * (np.array([255, 255, 255], np.uint8) - img)
        img = blend.clip(0, 255).astype(np.uint8)
    # Supersample downsample: float means, then uint8 truncation as in the
    # reference's implicit cast when blitting (grid.py:240).
    f = img.reshape(tile_size, subdivs, tile_size, subdivs, 3).astype(np.float64)
    return f.mean(axis=3).mean(axis=1).astype(np.uint8)


@lru_cache(maxsize=None)
def tile_atlas(tile_size: int = TILE_PIXELS) -> np.ndarray:
    """uint8[11, 6, 3, 5, 2, ts, ts, 3] atlas indexed by
    (type, color, state, agent_dir+1, highlight), as a host array."""
    atlas = np.zeros((11, 6, 3, 5, 2, tile_size, tile_size, 3), np.uint8)
    for t in range(11):
        states = range(3) if t == OBJ_DOOR else (0,)
        for col in range(6):
            for st in states:
                for ag in range(-1, 4):
                    for hl in (0, 1):
                        tile = _render_tile(t, col, st, ag, hl, tile_size)
                        if t == OBJ_DOOR:
                            atlas[t, col, st, ag + 1, hl] = tile
                        else:
                            atlas[t, col, :, ag + 1, hl] = tile
    return atlas


# (tile size, device) -> the atlas as uint8 [tiles, ts, ts, 3] there.
_DEVICE_ATLASES: dict[tuple[int, torch.device], torch.Tensor] = {}


def device_atlas(tile_size: int, device) -> torch.Tensor:
    """``tile_atlas(tile_size)`` flattened to uint8 [tiles, ts, ts, 3] on
    ``device``, moved there once."""
    key = (tile_size, torch.device(device))
    if key not in _DEVICE_ATLASES:
        flat = tile_atlas(tile_size).reshape(-1, tile_size, tile_size, 3)
        _DEVICE_ATLASES[key] = torch.from_numpy(flat).to(key[1])
    return _DEVICE_ATLASES[key]


def render_grid(
    grid: torch.Tensor,
    tile_size: int,
    agent_pos=None,
    agent_dir=None,
    highlight_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """uint8[N, H*ts, W*ts, 3] frames of packed int32[N, W, H] cell grids:
    one gather of atlas tiles, replacing the reference's per-tile Python
    loop (minigrid/core/grid.py:200-242).  ``agent_pos`` is an (x, y) pair
    of ints or int32 [N] tensors, ``agent_dir`` an int or int32 [N], and
    ``highlight_mask`` bool[N, W, H]."""
    n, w, h = grid.shape
    device = grid.device
    t, c, s = cell_type(grid).long(), cell_color(grid).long(), cell_state(grid).long()
    ag = torch.zeros_like(t)
    if agent_pos is not None:
        ax, ay = (torch.as_tensor(p, device=device).reshape(-1, 1, 1) for p in agent_pos)
        xs = torch.arange(w, device=device)[None, :, None]
        ys = torch.arange(h, device=device)[None, None, :]
        d = torch.as_tensor(agent_dir, device=device).long().reshape(-1, 1, 1)
        ag = torch.where((xs == ax) & (ys == ay), d + 1, ag)
    hl = torch.zeros_like(t) if highlight_mask is None else highlight_mask.long()
    flat = (((t * 6 + c) * 3 + s.clamp(0, 2)) * 5 + ag) * 2 + hl
    tiles = device_atlas(tile_size, device)[flat]  # [N, W, H, ts, ts, 3]
    return tiles.permute(0, 2, 3, 1, 4, 5).reshape(n, h * tile_size, w * tile_size, 3)
