"""``ParityRollout`` of the port (``minigrid_tpu_torch/compat/parity.py``)
against the JAX package's on the same seeds and actions, on the CPU: twelve
ids of every kind (DoorKey, Dynamic-Obstacles' host obstacle walk,
ObstructedMaze, Memory's action map, RedBlueDoors, PutNear, a WFC preset,
GoToLocal, PutNextLocal, BossLevel, a Carrying level and KeyInBox through
BabyAI's verifier), 40 numpy-seeded steps each with unseeded resets where
an episode ends: observation, direction, terminated, truncated and state
exact, rewards to rtol 1e-6.  Also the host stream across unseeded resets
and the inspection helpers along a rollout."""

from __future__ import annotations

import numpy as np
import pytest

from minigrid_tpu.compat import parity as jparity
from minigrid_tpu.utils.debug import pprint_grid as jax_pprint_grid
from minigrid_tpu.utils.debug import state_hash as jax_state_hash
from minigrid_tpu_torch.compat import parity as tparity
from minigrid_tpu_torch.utils.debug import pprint_grid, state_hash
from parity_port_util import assert_trajectory_parity

# (id, seed): the WFC level of seed 3 is the JAX package's trajectory test's.
TRAJECTORY_CASES = [
    ("MiniGrid-DoorKey-8x8-v0", 0),
    ("MiniGrid-Dynamic-Obstacles-8x8-v0", 0),
    ("MiniGrid-ObstructedMaze-2Dlh-v0", 0),
    ("MiniGrid-MemoryS13-v0", 0),
    ("MiniGrid-RedBlueDoors-8x8-v0", 0),
    ("MiniGrid-PutNear-8x8-N3-v0", 0),
    ("MiniGrid-WFC-MazeSimple-v0", 3),
    ("BabyAI-GoToLocal-v0", 0),
    ("BabyAI-PutNextLocal-v0", 0),
    ("BabyAI-BossLevel-v0", 0),
    ("BabyAI-PutNextS5N2Carrying-v0", 0),
    ("BabyAI-KeyInBox-v0", 0),
]


@pytest.mark.parametrize("env_id, seed", TRAJECTORY_CASES)
def test_trajectory_parity(env_id, seed):
    assert_trajectory_parity(env_id, seed=seed, steps=40)


def test_unseeded_resets_continue_the_stream():
    """A seeded rollout, then three unseeded resets of both: each continues
    the one host stream, as the reference's ``np_random`` does."""
    jroll = jparity.ParityRollout("MiniGrid-DoorKey-8x8-v0", 5)
    troll = tparity.ParityRollout("MiniGrid-DoorKey-8x8-v0", 5, device="cpu")
    for k in range(3):
        jroll.reset()
        troll.reset()
        np.testing.assert_array_equal(troll.state.grid[0].numpy(), np.asarray(jroll.state.grid), err_msg=f"reset {k}")
        assert int(troll.state.agent_dir[0]) == int(jroll.state.agent_dir)
    assert troll.rng.bit_generator.state == jroll.rng.bit_generator.state


@pytest.mark.parametrize("env_id", ["MiniGrid-DoorKey-8x8-v0", "MiniGrid-ObstructedMaze-1Q-v0"])
def test_debug_helpers_equal_jax_on_parity_states(env_id):
    """``state_hash`` (every size) and ``pprint_grid`` of a parity state and
    of its steps equal the JAX package's."""
    jroll = jparity.ParityRollout(env_id, 11)
    troll = tparity.ParityRollout(env_id, 11, device="cpu")
    for action in (1, 2, 2, 0, 2, 3):
        jroll.step(action)
        troll.step(action)
        for size in (8, 16, 64):
            assert state_hash(troll.state, size) == jax_state_hash(jroll.state, size)
        assert pprint_grid(troll.state) == jax_pprint_grid(jroll.state)
