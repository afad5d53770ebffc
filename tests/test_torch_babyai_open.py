"""BabyAI's Open levels in the PyTorch port (``envs/babyai/open.py``), against
the JAX package (the rules: ``tests/babyai_port_util.py``).

* Each of the module's 13 ids resets and steps at N=4; mission text equal
  to JAX's on the same encoded mission.
* Each of its 5 classes, on its smallest registered configuration, generates
  levels distributed as JAX's do (2048 attempts a side, 5 sigma).
* OpenDoorsOrderN4Debug (strict leaves, an action, Before or After at
  random): JAX's levels stepped by both packages, bit-identical.
"""

from __future__ import annotations

import pytest

from babyai_port_util import check_ids, check_steps_exact, compare_generation, jax_generation, module_ids

IDS = module_ids("open")
SMALLEST = {
    "Open": "BabyAI-Open-v0",
    "OpenRedDoor": "BabyAI-OpenRedDoor-v0",
    "OpenDoor": "BabyAI-OpenDoorDebug-v0",
    "OpenTwoDoors": "BabyAI-OpenTwoDoors-v0",
    "OpenDoorsOrder": "BabyAI-OpenDoorsOrderN4Debug-v0",
}
EXACT_ID = "BabyAI-OpenDoorsOrderN4Debug-v0"


def test_the_module_registers_its_13_ids():
    assert len(IDS) == 13 and set(SMALLEST.values()) <= set(IDS)


@pytest.mark.parametrize("env_id", IDS)
def test_every_open_id_resets_and_steps(env_id):
    check_ids(env_id)


@pytest.fixture(scope="module")
def levels():
    return jax_generation(SMALLEST)


@pytest.mark.parametrize("cls", list(SMALLEST))
def test_generation_matches_jax(levels, cls):
    compare_generation(SMALLEST[cls], levels[cls])


def test_steps_are_exact_on_jax_levels(levels):
    check_steps_exact(EXACT_ID, levels["OpenDoorsOrder"])
