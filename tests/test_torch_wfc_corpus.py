"""The port's WFC levels against the reference corpus
(``tests/golden/wfc_ref_corpus.npz``: 48 levels a preset at size 25, made
by the original Minigrid), with the thresholds of ``tests/test_wfc.py``'s
``test_distribution_matches_reference``: the 2x2 wall-block distribution
within a total variation distance of 0.10, the wall density within
max(4 se, 0.04), walls and floor only.  The plain solver on the CPU, one
thread; the GPU tests and chip_smoke.py hold all six presets on the card."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import minigrid_tpu_torch as mgt
from minigrid_tpu_torch.core.constants import OBJ_WALL, cell_type
from minigrid_tpu_torch.utils.golden import wfc_corpus_check
from torch_port_util import one_torch_thread  # noqa: F401  (fixture)

CORPUS = os.path.join(os.path.dirname(__file__), "golden", "wfc_ref_corpus.npz")


@pytest.mark.parametrize("preset", ["MazeSimple", "ObstaclesBlackdots", "DungeonMazeScaled"])
def test_levels_match_the_reference_corpus(one_torch_thread, preset):
    ref_walls = np.load(CORPUS)[f"{preset}_walls"]
    env = mgt.make(f"MiniGrid-WFC-{preset}-v0")
    _, states = env.reset(ref_walls.shape[0], torch.Generator().manual_seed(11), "cpu")
    ours = (cell_type(states.grid) == OBJ_WALL).numpy()[:, 1:-1, 1:-1]
    tvd, density, ref_density, limit = wfc_corpus_check(ours, ref_walls)
    assert tvd < 0.10, f"{preset}: block-distribution TVD {tvd:.3f}"
    assert abs(density - ref_density) < limit, f"{preset}: density {density:.3f} vs reference {ref_density:.3f}"
