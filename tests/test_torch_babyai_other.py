"""BabyAI's other levels in the PyTorch port (``envs/babyai/other.py``),
against the JAX package (the rules: ``tests/babyai_port_util.py``); the
registry's id set; the reset cache's pool.

* Each of the module's 17 ids resets and steps at N=4; mission text equal
  to JAX's.
* Each of its 5 classes, on its smallest registered configuration,
  generates levels distributed as JAX's do (2048 attempts a side,
  5 sigma).
* ActionObjDoor (a go-to, pick-up or open leaf at random): JAX's levels
  stepped by both packages, bit-identical.
* The port registers every id of the JAX package but the six WFC ids.
* A reset cache whose first pool holds too few valid attempts draws more
  and uses no level twice.
"""

from __future__ import annotations

import pytest
import torch

from babyai_port_util import check_ids, check_steps_exact, compare_generation, jax_generation, module_ids
import minigrid_tpu.registry as jax_registry
import minigrid_tpu_torch as mgt
from minigrid_tpu_torch.core.constants import OBJ_WALL
from minigrid_tpu_torch.envs.babyai.goto import GoToObj

IDS = module_ids("other")
SMALLEST = {
    "ActionObjDoor": "BabyAI-ActionObjDoor-v0",
    "FindObjS5": "BabyAI-FindObjS5-v0",
    "KeyCorridor": "BabyAI-KeyCorridorS3R1-v0",
    "OneRoomS8": "BabyAI-OneRoomS8-v0",
    "MoveTwoAcross": "BabyAI-MoveTwoAcrossS5N2-v0",
}


def test_the_module_registers_its_17_ids():
    assert len(IDS) == 17 and set(SMALLEST.values()) <= set(IDS)


@pytest.mark.parametrize("env_id", IDS)
def test_every_other_id_resets_and_steps(env_id):
    check_ids(env_id)


@pytest.fixture(scope="module")
def levels():
    return jax_generation(SMALLEST)


@pytest.mark.parametrize("cls", list(SMALLEST))
def test_generation_matches_jax(levels, cls):
    compare_generation(SMALLEST[cls], levels[cls])


def test_steps_are_exact_on_jax_levels(levels):
    check_steps_exact("BabyAI-ActionObjDoor-v0", levels["ActionObjDoor"])


def test_the_registry_holds_every_jax_id_but_wfc():
    # Every JAX id, WFC's six included: the registry is whole.
    want = set(jax_registry.registered_ids())
    assert set(mgt.registered_ids()) == want and len(want) == 177
    assert sum(i.startswith("BabyAI-") for i in want) == 96
    assert sum(i.startswith("MiniGrid-WFC-") for i in want) == 6


class _RarelyValid(GoToObj):
    """GoToObjS4 whose attempts are valid one time in ten (``valid_every``),
    each stamped with its serial number in the corner wall's color and
    state bits."""

    pool_factor = 2.0

    def __init__(self, valid_every: int = 10):
        super().__init__(room_size=4)
        self.valid_every, self.serial = valid_every, 0

    def gen_attempt(self, generator, n, device):
        s, instr, valid = super().gen_attempt(generator, n, device)
        serial = torch.arange(self.serial, self.serial + n, dtype=torch.int32, device=device)
        self.serial += n
        grid = s.grid.clone()
        grid[:, 0, 0] = OBJ_WALL | (serial << 8)
        return s.replace(grid=grid), instr, valid & (serial % self.valid_every == 0)


def test_a_short_pool_draws_more_and_repeats_no_level():
    env = _RarelyValid()
    cache = env.batch_reset_cache(64, 4, torch.Generator().manual_seed(0), "cpu")
    serials = cache.grid[:, :, 0, 0] >> 8
    assert serials.shape == (64, 4) and bool((serials % 10 == 0).all())
    assert serials.unique().numel() == 256  # every level a different attempt
    # The first pool (2 x 256 attempts) held ~51 valid ones: more were drawn.
    assert env.serial > 2 * 256 and int(serials.max()) >= 2 * 256


def test_a_level_that_is_never_valid_raises():
    env = _RarelyValid(valid_every=2**30)
    env.serial = 1  # no serial of this run is a multiple
    with pytest.raises(RuntimeError, match="valid levels"):
        env.batch_reset_cache(4, 2, torch.Generator().manual_seed(0), "cpu")
    assert env.serial - 1 >= 4 * 2 * env.max_gen_attempts
