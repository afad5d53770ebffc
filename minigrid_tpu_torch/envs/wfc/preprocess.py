"""Host-side WFC preprocessing: pattern catalog and adjacency extraction.

Counterpart of ``minigrid_tpu/envs/wfc/preprocess.py``, in host numpy as
there: the per-preset tables (pattern contents, weights, legal-adjacency
matrices) are built once from the stored tile-grid assets in
``patterns_data/`` (the reference builds them from PNG images at every env
construction: minigrid/envs/wfc/wfclogic/tiles.py, patterns.py:16-179,
adjacency.py:8-56).  Both packages build identical tables from identical
files; the solver (``solver.py``) moves them to the device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

DATA_DIR = os.path.join(os.path.dirname(__file__), "patterns_data")

# Cardinal directions in the reference's order (control.py:107).
DIRECTIONS = ((0, -1), (1, 0), (0, 1), (-1, 0))


@dataclass(frozen=True)
class WFCConfig:
    """Mirror of the reference's WFCConfig (minigrid/envs/wfc/config.py:12-54);
    ``pattern`` names one of the stored tile-grid assets."""

    pattern: str
    tile_size: int = 1
    pattern_width: int = 2
    rotations: int = 8
    output_periodic: bool = False
    input_periodic: bool = False
    loc_heuristic: str = "entropy"
    choice_heuristic: str = "weighted"
    backtracking: bool = False


# The six fast presets the reference registers
# (reference: minigrid/envs/wfc/config.py:57-104).
WFC_PRESETS = {
    "MazeSimple": WFCConfig("SimpleMaze", pattern_width=2),
    "DungeonMazeScaled": WFCConfig("ScaledMaze", pattern_width=2, output_periodic=True, input_periodic=True),
    "RoomsFabric": WFCConfig("Fabric", pattern_width=3),
    "ObstaclesBlackdots": WFCConfig("Blackdots", pattern_width=2),
    "ObstaclesAngular": WFCConfig("Angular", pattern_width=3, output_periodic=True, input_periodic=True),
    "ObstaclesHogs3": WFCConfig("Hogs", pattern_width=3, output_periodic=True, input_periodic=True),
}

# Presets the reference ships but does not register: occasionally
# contradiction-prone ones (reference config.py:104-140) and slow ones
# (config.py:142-221).  Usable via WFCEnv(wfc_config=WFC_PRESETS_ALL[name]).
WFC_PRESETS_INCONSISTENT = {
    "MazeKnot": WFCConfig("Knot", pattern_width=3, output_periodic=True, input_periodic=True),
    "MazeWall": WFCConfig("SimpleWall", pattern_width=2, output_periodic=True, input_periodic=True),
    "RoomsOffice": WFCConfig("Office", pattern_width=3, output_periodic=True, input_periodic=True),
    "ObstaclesHogs2": WFCConfig("Hogs", pattern_width=2, output_periodic=True, input_periodic=True),
    "Skew2": WFCConfig("Skew2", pattern_width=3, output_periodic=True, input_periodic=True),
}

WFC_PRESETS_SLOW = {
    "Maze": WFCConfig("Maze", pattern_width=3, output_periodic=True, input_periodic=True),
    "MazeSpirals": WFCConfig("Spirals", pattern_width=3, output_periodic=True, input_periodic=True),
    "MazePaths": WFCConfig("Paths", pattern_width=3, output_periodic=True, input_periodic=True),
    "Mazelike": WFCConfig("Mazelike", pattern_width=3, output_periodic=True, input_periodic=True),
    "Dungeon": WFCConfig("DungeonExtr", pattern_width=3, output_periodic=True, input_periodic=True),
    "DungeonRooms": WFCConfig("Rooms", pattern_width=3, output_periodic=True, input_periodic=True),
    "DungeonLessRooms": WFCConfig("LessRooms", pattern_width=3, output_periodic=True, input_periodic=True),
    "DungeonSpirals": WFCConfig("SpiralsNeg", pattern_width=3, output_periodic=True, input_periodic=True),
    "RoomsMagicOffice": WFCConfig("MagicOffice", pattern_width=3, output_periodic=True, input_periodic=True),
    "SkewCave": WFCConfig("Cave", pattern_width=3),
    "SkewLake": WFCConfig("Lake", pattern_width=3, output_periodic=True, input_periodic=True),
}

WFC_PRESETS_ALL = {**WFC_PRESETS, **WFC_PRESETS_INCONSISTENT, **WFC_PRESETS_SLOW}


def _dihedral_grids(grid: np.ndarray, rotations: int):
    """The cumulative identity/reflect/rotate op sequence of the reference
    (patterns.py:148-169): ``rotations`` transformed grids."""
    ops = ["id", "refl", "rot", "refl", "rot", "refl", "rot", "refl"]
    g = grid.copy()
    out = []
    for i in range(rotations):
        op = ops[i]
        if op == "refl":
            g = np.fliplr(g)
        elif op == "rot":
            g = np.rot90(g, axes=(1, 0))
        out.append(g.copy())
    return out


def _extract_patterns(grid: np.ndarray, k: int):
    """All k x k wrap-padded windows as [N, k, k] (the reference wrap-pads in
    both periodic and non-periodic mode, patterns.py:20-33)."""
    padded = np.pad(grid, ((0, k - 1), (0, k - 1)), mode="wrap")
    win = np.lib.stride_tricks.sliding_window_view(padded, (k, k))
    return win.reshape(-1, k, k)


def legal_adjacency(pats: np.ndarray) -> np.ndarray:
    """bool[4, P, P] legal adjacencies per direction for [P, k, k] patterns:
    q offset by DIRECTIONS[d] from p agrees with p on their overlap
    (reference adjacency.py:17-47), over all (p, q) pairs at once."""
    P, k, _ = pats.shape
    adj = np.zeros((4, P, P), bool)
    for di, (dx, dy) in enumerate(DIRECTIONS):
        # p's cells [r, c] overlap q's cells [r - dy, c - dx] (q is shifted by
        # (dx, dy) in (col, row) = (x, y) convention).
        r0p, r1p = max(0, dy), min(k, k + dy)
        c0p, c1p = max(0, dx), min(k, k + dx)
        r0q, r1q = max(0, -dy), min(k, k - dy)
        c0q, c1q = max(0, -dx), min(k, k - dx)
        a = pats[:, r0p:r1p, c0p:c1p].reshape(P, -1)
        b = pats[:, r0q:r1q, c0q:c1q].reshape(P, -1)
        adj[di] = (a[:, None, :] == b[None, :, :]).all(-1)
    return adj


def build_tables(config: WFCConfig):
    """Returns dict of numpy arrays:
    * patterns: int32[P, k, k] tile ids
    * weights:  float32[P] (the orientation passes that contain the pattern)
    * adj:      bool[4, P, P] legal adjacencies per direction
    * top_left: int32[P] pattern -> tile id of its anchor cell
    * wall_tile: int32 id of the black tile (walls), -1 if absent
    """
    with np.load(os.path.join(DATA_DIR, config.pattern + ".npz")) as z:
        tile_grid = z["tile_grid"]
        colors = z["colors"]
    assert config.tile_size == 1
    k = config.pattern_width

    # Pattern weight = number of orientation passes CONTAINING the pattern,
    # not its occurrence count: the reference's pattern_frequency is a
    # Counter over the per-pass UNIQUE pattern list (patterns.py:89-99,
    # summed across passes in make_pattern_catalog_with_rotations:133-146),
    # so within one pass every pattern contributes exactly 1.
    all_pats = []
    for g in _dihedral_grids(tile_grid, config.rotations):
        pats_g = _extract_patterns(g, k)
        all_pats.append(np.unique(pats_g.reshape(pats_g.shape[0], -1), axis=0))
    stacked = np.concatenate(all_pats)  # [sum of per-pass uniques, k*k]
    patterns, counts = np.unique(stacked, axis=0, return_counts=True)
    P = patterns.shape[0]
    pats = patterns.reshape(P, k, k).astype(np.int32)

    adj = legal_adjacency(pats)

    # Wall tile: the black color (reference WFCEnv.PATTERN_COLOR_CONFIG).
    wall_candidates = np.where((colors == 0).all(axis=1))[0]
    wall_tile = int(wall_candidates[0]) if wall_candidates.size else -1

    return {
        "patterns": pats,
        "weights": counts.astype(np.float32),
        "adj": adj,
        "top_left": pats[:, 0, 0].astype(np.int32),
        "wall_tile": wall_tile,
    }


@lru_cache(maxsize=None)
def preset_tables(name: str):
    return build_tables(WFC_PRESETS[name])
