"""The WFC solver kernel's host side (``minigrid_tpu_torch/ops/wfc_solve.py``)
on the CPU: the support table it builds from ``adj`` transposed, the Python
mirror of its shared-memory layout on the H100's figures, and its refusal of
more patterns than it takes.  The kernel itself runs only on the card
(``tests/test_torch_cuda.py -k wfc``)."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from minigrid_tpu_torch.envs.wfc.preprocess import WFC_PRESETS_ALL, build_tables
from minigrid_tpu_torch.ops import wfc_solve as wk

# The H100's SMs and shared memory a block (opt-in).
H100_SMS = 132
H100_SMEM = 232_448


@functools.lru_cache(maxsize=None)
def _adj(preset: str) -> np.ndarray:
    return np.asarray(build_tables(WFC_PRESETS_ALL[preset])["adj"], bool)


def _unpacked(words: np.ndarray, p: int) -> np.ndarray:
    """uint64 [Q, 4, NW] rows as bool [Q, 4, P]."""
    bits = (words[..., None] >> np.arange(64, dtype=np.uint64)) & np.uint64(1)
    return bits.reshape(*words.shape[:2], -1)[..., :p].astype(bool)


def _random_adj(p: int, seed: int) -> np.ndarray:
    adj = np.random.default_rng(seed).random((4, p, p)) < 0.3
    assert any(not np.array_equal(adj[d], adj[(d + 2) % 4].T) for d in range(4))
    return adj


@pytest.mark.parametrize("source", [*sorted(WFC_PRESETS_ALL), "random 7", "random 130"])
def test_support_words_are_adj_transposed_bit_for_bit(source):
    adj = _random_adj(int(source.split()[1]), 3) if source.startswith("random") else _adj(source)
    p = adj.shape[1]
    words = wk.support_words(adj)
    assert words.dtype == np.uint64 and words.shape == (p, 4, (p + 63) // 64)
    rows = _unpacked(words, p)
    for d in range(4):
        # Row (q, d): the patterns p with adj[(d + 2) % 4, p, q].
        np.testing.assert_array_equal(rows[:, d, :], adj[(d + 2) % 4].T)
    # No bit past P.
    assert not (_unpacked(words, 64 * words.shape[2])[..., p:]).any()


@pytest.mark.parametrize("backtracking", [False, True])
@pytest.mark.parametrize("size", [12, 23])
def test_every_preset_fits_and_small_batches_take_a_block_a_wave(size, backtracking):
    for preset in WFC_PRESETS_ALL:
        p = _adj(preset).shape[1]
        big = wk.wfc_solve_layout(p, size, size, backtracking, 20480, H100_SMS, H100_SMEM)
        assert 1 <= big["waves_per_block"] <= wk.MAX_WAVES[(p + 63) // 64], preset
        assert big["smem_bytes"] + wk.SMEM_RESERVE <= H100_SMEM, preset
        assert big["smem_bytes"] == big["block_bytes"] + big["waves_per_block"] * big["wave_bytes"]
        assert big["block_bytes"] % 16 == 0 and big["wave_bytes"] % 16 == 0
        for n in (1, 64, H100_SMS):
            assert wk.wfc_solve_layout(p, size, size, backtracking, n, H100_SMS, H100_SMEM)["waves_per_block"] == 1
        # Past one a SM, blocks take more waves, up to what fits.
        more = wk.wfc_solve_layout(p, size, size, backtracking, H100_SMS + 1, H100_SMS, H100_SMEM)
        assert more["waves_per_block"] == min(2, big["waves_per_block"])
    maze = wk.wfc_solve_layout(229, size, size, backtracking, 20480, H100_SMS, H100_SMEM)
    assert maze["waves_per_block"] >= 2


def test_the_layout_refuses_a_wave_that_does_not_fit():
    layout = wk.wfc_solve_layout(229, 200, 200, True, 4, H100_SMS, H100_SMEM)
    assert layout["waves_per_block"] == 0 and layout["smem_bytes"] == layout["block_bytes"]


def test_the_wrapper_still_refuses_300_patterns():
    seeds = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="300 patterns"):
        wk.wfc_solve_kernel(seeds, np.ones((4, 300, 300), bool), torch.ones(300), None, (5, 5), False, 1,
                            "entropy", "weighted", False)
    # Within the patterns it takes, a CPU tensor is refused: the plain
    # version is envs/wfc/solver.wfc_solve_reference.
    with pytest.raises(ValueError, match="need CUDA"):
        wk.wfc_solve_kernel(seeds, np.ones((4, 3, 3), bool), torch.ones(3), None, (5, 5), False, 1,
                            "entropy", "weighted", False)
