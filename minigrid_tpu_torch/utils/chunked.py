"""Level generation in sequential chunks of bounded memory.

Counterpart of ``minigrid_tpu/utils/chunked.py``.  A batched generator's
intermediates (placement masks, the int32 rank scan of every placement,
the masked blends of the grid) grow with lanes x grid cells: one pass over
FourRooms' reset cache at 65536 envs x R=7 is 458752 lanes of 361 cells,
and a single int64 rank scan over it alone would take 1.3 GB.  ``chunked``
runs the generator on at most ``max_lanes`` lanes at a time and
concatenates the results, so the live intermediates are one chunk's.

The chunks draw from the caller's generator one after another, so a lane's
level depends on the chunk size as well as on the generator's state; the
chunk size is a function of the grid's cell count alone (``lane_cap``), so
the same call on the same generator state gives the same levels.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core.state import tree_map

# Cell-lanes per chunk.  The generators keep about 60 bytes per cell-lane
# live at their peak (int32 grids and blends, bool masks, the int32 rank
# scan), so a chunk of 2^27 cell-lanes peaks near 8 GB: a tenth of the
# H100's 80 GB, leaving the rest to the reset cache being built (FourRooms'
# grid and contents planes at 65536 x 7 are 1.3 GB) and to a learner
# running beside it.
CELL_LANE_BUDGET = 1 << 27


def lane_cap(cells: int) -> int:
    """Lanes per chunk for a grid of ``cells`` cells (a multiple of 1024)."""
    return max(1024, (CELL_LANE_BUDGET // max(int(cells), 1)) // 1024 * 1024)


def cat_trees(parts):
    """Trees of tensors (states with their ``extra``, say) concatenated
    along the leading axis, leaf by leaf."""
    return tree_map(lambda *xs: torch.cat(xs), *parts)


def chunked(generate, n: int, max_lanes: int):
    """``generate(count)``, a tree of tensors (an ``EnvState``, say) of
    ``count`` lanes, called on sequential chunks of at most ``max_lanes``
    lanes that add up to ``n``; the chunks' trees concatenated."""
    if n <= max_lanes:
        return generate(n)
    return cat_trees([generate(min(max_lanes, n - start)) for start in range(0, n, max_lanes)])
