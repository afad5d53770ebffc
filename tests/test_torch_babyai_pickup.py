"""BabyAI's Pickup and PutNext levels in the PyTorch port
(``envs/babyai/pickup.py``, ``putnext.py``), against the JAX package (the
rules: ``tests/babyai_port_util.py``).

* Each of the modules' 5 + 11 ids resets and steps at N=4; mission text
  equal to JAX's.
* Each of their 6 classes, on its smallest registered configuration (and
  PutNext with ``start_carrying`` too), generates levels distributed as
  JAX's do (2048 attempts a side, 5 sigma).
* PickupDistDebug (a strict leaf) and PutNextS5N2Carrying (the agent
  starts with the object to move, in the reset cache's levels too): JAX's
  levels stepped by both packages, bit-identical.
* ``start_carrying_object`` equals JAX's on the same instructions.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from babyai_port_util import check_ids, check_steps_exact, compare_generation, jax_generation, module_ids, to_port
from minigrid_tpu.envs.babyai.core.instr import start_carrying_object as j_start_carrying_object
from minigrid_tpu_torch.envs.babyai.core.instr import start_carrying_object, tracked_plane
from torch_port_util import assert_states_equal

IDS = module_ids("pickup") + module_ids("putnext")
SMALLEST = {
    "Pickup": "BabyAI-Pickup-v0",
    "UnblockPickup": "BabyAI-UnblockPickup-v0",
    "PickupDist": "BabyAI-PickupDistDebug-v0",
    "PickupAbove": "BabyAI-PickupAbove-v0",
    "PutNextLocal": "BabyAI-PutNextLocalS5N3-v0",
    "PutNext": "BabyAI-PutNextS4N1-v0",
    "PutNext start_carrying": "BabyAI-PutNextS5N2Carrying-v0",
}
EXACT = {"BabyAI-PickupDistDebug-v0": "PickupDist", "BabyAI-PutNextS5N2Carrying-v0": "PutNext start_carrying"}


def test_the_modules_register_their_16_ids():
    assert len(IDS) == 16 and set(SMALLEST.values()) <= set(IDS)


@pytest.mark.parametrize("env_id", IDS)
def test_every_pickup_and_putnext_id_resets_and_steps(env_id):
    check_ids(env_id)


@pytest.fixture(scope="module")
def levels():
    return jax_generation(SMALLEST, ("PutNext start_carrying",))


@pytest.mark.parametrize("cls", list(SMALLEST))
def test_generation_matches_jax(levels, cls):
    compare_generation(SMALLEST[cls], levels[cls])


@pytest.mark.parametrize("env_id", list(EXACT))
def test_steps_are_exact_on_jax_levels(levels, env_id):
    check_steps_exact(env_id, levels[EXACT[env_id]])


def test_carrying_levels_start_with_the_move_object_in_hand(levels):
    state = to_port(levels["PutNext start_carrying"])
    instr = state.extra["instr"]
    assert bool(instr.carried[:, 0, 0].all()) and not bool(tracked_plane(instr.gridm, 0, 0).any())
    assert torch.equal(state.carrying, instr.d_type[:, 0, 0] | (instr.d_color[:, 0, 0] << 8))


def test_start_carrying_object_matches_jax(levels):
    # PutNextLocal's instructions, lifted at the move object's cell and at
    # a random cell (mostly untracked).
    jstates = levels["PutNextLocal"]
    state = to_port(jstates)
    instr, (n, w, h) = state.extra["instr"], state.grid.shape
    move = tracked_plane(instr.gridm, 0, 0).reshape(n, -1).to(torch.uint8).argmax(dim=1)
    rng = np.random.default_rng(2)
    for idx in (move, torch.from_numpy(rng.integers(0, w * h, n))):
        pos = torch.stack([idx // h, idx % h], dim=1).int()
        got = start_carrying_object(instr, pos)
        want = jax.vmap(j_start_carrying_object)(jstates.extra["instr"], pos.numpy())
        assert_states_equal(state.replace(extra={"instr": got}), jstates.replace(extra={"instr": want}), "lifted")
    assert bool(start_carrying_object(instr, torch.stack([move // h, move % h], dim=1)).carried[:, 0, 0].all())
