"""BabyAI's Unlock levels in the PyTorch port (``envs/babyai/unlock.py``),
against the JAX package (the rules: ``tests/babyai_port_util.py``).

* Each of the module's 8 ids resets and steps at N=4; mission text equal
  to JAX's.
* Each of its 6 classes, on its smallest registered configuration,
  generates levels distributed as JAX's do (2048 attempts a side,
  5 sigma), KeyInBox's box contents included.
* KeyInBox (its key in the contents plane, in the reset cache's levels
  too): JAX's levels stepped by both packages, bit-identical.
"""

from __future__ import annotations

import pytest
import torch

from babyai_port_util import check_ids, check_steps_exact, compare_generation, jax_generation, module_ids
import minigrid_tpu_torch as mgt
from minigrid_tpu_torch.core.constants import OBJ_BOX, OBJ_DOOR, OBJ_KEY, STATE_LOCKED, cell, cell_color, cell_state, cell_type

IDS = module_ids("unlock")
SMALLEST = {
    "Unlock": "BabyAI-Unlock-v0",
    "UnlockLocal": "BabyAI-UnlockLocalDist-v0",
    "KeyInBox": "BabyAI-KeyInBox-v0",
    "UnlockPickup": "BabyAI-UnlockPickupDist-v0",
    "BlockedUnlockPickup": "BabyAI-BlockedUnlockPickup-v0",
    "UnlockToUnlock": "BabyAI-UnlockToUnlock-v0",
}


def test_the_module_registers_its_8_ids():
    assert len(IDS) == 8 and set(SMALLEST.values()) <= set(IDS)


@pytest.mark.parametrize("env_id", IDS)
def test_every_unlock_id_resets_and_steps(env_id):
    check_ids(env_id)


@pytest.fixture(scope="module")
def levels():
    return jax_generation(SMALLEST, ("KeyInBox",))


@pytest.mark.parametrize("cls", list(SMALLEST))
def test_generation_matches_jax(levels, cls):
    compare_generation(SMALLEST[cls], levels[cls])


def test_steps_are_exact_on_jax_levels(levels):
    check_steps_exact("BabyAI-KeyInBox-v0", levels["KeyInBox"])


def test_key_in_box_cache_levels_hold_the_key():
    # The reset cache's levels hold the locked door's key in their box, as
    # the levels of a reset do.
    env = mgt.make("BabyAI-KeyInBox-v0")
    cache = env.batch_reset_cache(16, 3, torch.Generator().manual_seed(1))
    grid, contains = cache.grid.flatten(0, 1), cache.contains.flatten(0, 1)
    locked = (cell_type(grid) == OBJ_DOOR) & (cell_state(grid) == STATE_LOCKED)
    door_color = torch.where(locked, cell_color(grid), 0).flatten(1).sum(dim=1)
    box = cell_type(grid) == OBJ_BOX
    assert bool((box.flatten(1).sum(dim=1) == 1).all()) and bool((locked.flatten(1).sum(dim=1) == 1).all())
    assert torch.equal(contains[box], cell(OBJ_KEY, door_color).int())
    assert int(contains[~box].abs().sum()) == 0
