"""BabyAI's LevelGen levels in the PyTorch port (``envs/babyai/levelgen.py``),
against the JAX package (the rules: ``tests/babyai_port_util.py``).  The
LevelGen classes are split over three files, three JAX compiles of ~20 s
at most each: this one, ``test_torch_babyai_boss.py`` and
``test_torch_babyai_synth.py``.

* Each of the module's 10 ids resets and steps at N=4; mission text equal
  to JAX's.
* MiniBossLevel and PickupLoc generate levels distributed as JAX's valid
  attempts are (2048 attempts a side, 5 sigma), with the same validity.
* MiniBossLevel (every leaf kind and combinator): JAX's levels stepped by
  both packages, bit-identical; ``num_navs`` equal to JAX's on the same
  instructions.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

import torch

from babyai_port_util import N_GEN, SIGMAS, check_ids, check_steps_exact, compare_generation, jax_valid_attempts, module_ids, one_torch_thread, to_port
import minigrid_tpu_torch as mgt
from minigrid_tpu.envs.babyai.core.instr import num_navs as j_num_navs
from minigrid_tpu_torch.envs.babyai.core.instr import num_navs

IDS = module_ids("levelgen")
CLASSES = {"MiniBossLevel": "BabyAI-MiniBossLevel-v0", "PickupLoc": "BabyAI-PickupLoc-v0"}


def test_the_module_registers_its_10_ids():
    assert len(IDS) == 10 and {"BabyAI-GoToSeq-v0", "BabyAI-GoToSeqS5R2-v0"} <= set(IDS)


@pytest.mark.parametrize("env_id", IDS)
def test_every_levelgen_id_resets_and_steps(env_id):
    check_ids(env_id)


@pytest.fixture(scope="module")
def levels():
    return {cls: jax_valid_attempts(env_id, N_GEN) for cls, env_id in CLASSES.items()}


@pytest.mark.parametrize("cls", list(CLASSES))
def test_generation_matches_jax(levels, cls):
    compare_generation(CLASSES[cls], levels[cls][0])


@pytest.mark.parametrize("cls", list(CLASSES))
@one_torch_thread()
def test_validity_matches_jax(levels, cls):
    env = mgt.make(CLASSES[cls])
    _, _, valid = env._attempt(torch.Generator().manual_seed(5), N_GEN, "cpu")
    got, want = float(valid.float().mean()), levels[cls][1]
    p = (got + want) / 2
    assert abs(got - want) <= SIGMAS * np.sqrt(p * (1 - p) * 2 / N_GEN), (got, want)


def test_steps_are_exact_on_jax_levels(levels):
    check_steps_exact("BabyAI-MiniBossLevel-v0", levels["MiniBossLevel"][0])


def test_num_navs_matches_jax(levels):
    jstates = levels["MiniBossLevel"][0]
    instr = to_port(jstates).extra["instr"]
    want = np.asarray(jax.vmap(j_num_navs)(jstates.extra["instr"]))
    np.testing.assert_array_equal(num_navs(instr).numpy(), want)
    assert len(np.unique(want)) >= 4  # one to several leaves, PutNext counting 2
