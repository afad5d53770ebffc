"""Seed-parity mode of the port (``minigrid_tpu_torch/compat/parity.py``)
against the JAX package's (``minigrid_tpu/compat/parity.py``), which
``tests/test_seed_parity.py`` holds to the original Minigrid: the classic
families' host generators, the seeding, and the inspection helpers of
``utils/debug.py``, on the CPU, bit for bit.  ``ParityRollout`` is held in
``tests/test_torch_parity_rollout.py``."""

from __future__ import annotations

import os

import jax
import numpy as np
import pytest
import torch

import minigrid_tpu as mg
import minigrid_tpu_torch as mgt
from minigrid_tpu.compat import parity as jparity
from minigrid_tpu.core.state import new_state as jax_new_state
from minigrid_tpu.utils.debug import state_hash as jax_state_hash
from minigrid_tpu_torch.compat import parity as tparity
from minigrid_tpu_torch.core.state import new_state
from minigrid_tpu_torch.utils.debug import pprint_grid, state_hash
from parity_port_util import assert_reset_parity

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

# One id of each of the 23 classic generators of PARITY_GENERATORS.
CLASSIC_IDS = [
    "MiniGrid-Empty-Random-6x6-v0",
    "MiniGrid-DistShift1-v0",
    "MiniGrid-LavaGapS6-v0",
    "MiniGrid-SimpleCrossingS9N2-v0",
    "MiniGrid-DoorKey-8x8-v0",
    "MiniGrid-FourRooms-v0",
    "MiniGrid-Dynamic-Obstacles-8x8-v0",
    "MiniGrid-GoToDoor-8x8-v0",
    "MiniGrid-Fetch-8x8-N3-v0",
    "MiniGrid-GoToObject-8x8-N2-v0",
    "MiniGrid-PutNear-8x8-N3-v0",
    "MiniGrid-RedBlueDoors-8x8-v0",
    "MiniGrid-MemoryS13Random-v0",
    "MiniGrid-Playground-v0",
    "MiniGrid-LockedRoom-v0",
    "MiniGrid-MultiRoom-N4-S5-v0",
    "MiniGrid-Unlock-v0",
    "MiniGrid-UnlockPickup-v0",
    "MiniGrid-BlockedUnlockPickup-v0",
    "MiniGrid-KeyCorridorS3R3-v0",
    "MiniGrid-ObstructedMaze-1Dlhb-v0",
    "MiniGrid-ObstructedMaze-1Q-v0",
    "MiniGrid-ObstructedMaze-Full-v1",
]
SEEDS = (0, 7)


def test_the_ids_cover_every_classic_generator():
    """Each entry of PARITY_GENERATORS but WFC's has an id here, and both
    packages resolve every id of the registry to the same generator."""
    covered = {tparity._lookup_generator(mgt.make(i)).__name__ for i in CLASSIC_IDS}
    classic = {g.__name__ for k, g in tparity.PARITY_GENERATORS.items() if k != "WFCEnv"}
    assert covered == classic and len(classic) == 22 and len(tparity.PARITY_GENERATORS) == 24
    # 23 classes share 22 functions: UnlockPickup and BlockedUnlockPickup.
    assert len([k for k in tparity.PARITY_GENERATORS if k != "WFCEnv"]) == 23
    for env_id in mgt.registered_ids():
        port = tparity._lookup_generator(mgt.make(env_id))
        ref = jparity._lookup_generator(mg.make(env_id))
        assert port is not None and port.__name__ == ref.__name__, env_id


@pytest.mark.parametrize("env_id", CLASSIC_IDS)
def test_reset_parity(env_id):
    assert_reset_parity(env_id, SEEDS)


def test_np_random_equals_gymnasium_seeding():
    gym_seeding = pytest.importorskip("gymnasium.utils.seeding")
    for seed in (0, 1, 7, 123, 2**40 + 3):
        ours, ours_entropy = tparity.np_random(seed)
        theirs, their_entropy = gym_seeding.np_random(seed)
        assert ours_entropy == their_entropy
        assert ours.bit_generator.state == theirs.bit_generator.state
        np.testing.assert_array_equal(ours.integers(0, 1000, 16), theirs.integers(0, 1000, 16))
    for bad in (-1, 1.5):
        with pytest.raises(ValueError):
            tparity.np_random(bad)


def test_parity_reset_puts_the_state_on_the_device_asked_for():
    env, state = tparity.parity_reset("MiniGrid-Fetch-8x8-N3-v0", 3, device="cpu")
    assert all(t.device.type == "cpu" for t in (state.grid, state.mission, state.extra["target_type"]))
    assert state.grid.dtype == torch.int32 and state.terminated.dtype == torch.bool
    assert state.step_count.shape == (1,) and int(state.step_count[0]) == 0


def test_pprint_grid_matches_the_reference_golden():
    """pprint output is byte-identical to the reference's pprint_grid for
    reference-generated grids (``tests/golden/pprint.npz``; reference
    minigrid_env.py:175-233)."""
    with np.load(os.path.join(GOLDEN, "pprint.npz")) as z:
        n = int(z["n"])
        assert n >= 3
        for i in range(n):
            grid = torch.from_numpy(z[f"g{i}_grid"])[None]
            state = new_state(grid, torch.from_numpy(z[f"g{i}_pos"]), int(z[f"g{i}_dir"]), 10)
            assert pprint_grid(state) == str(z[f"g{i}_text"]), i


def test_state_hash_tells_states_apart():
    _, state = tparity.parity_reset("MiniGrid-DoorKey-8x8-v0", 0, device="cpu")
    turned = state.replace(agent_dir=(state.agent_dir + 1) % 4)
    assert state_hash(state) != state_hash(turned)
    assert len(state_hash(state, size=20)) == 20
    jstate = jax_new_state(
        grid=jax.numpy.asarray(state.grid[0].numpy()),
        agent_pos=(int(state.agent_x[0]), int(state.agent_y[0])),
        agent_dir=int(state.agent_dir[0]),
        rng=jax.random.PRNGKey(0),
        max_steps=10,
    )
    assert state_hash(state) == jax_state_hash(jstate)
