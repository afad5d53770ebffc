"""The port's oracle bot on the port's own levels, on the CPU: the success
rule of ``tests/test_babyai_bot.py::test_bot_solves_level`` on its
``FAST_IDS`` (two successes in six attempts, one in twelve on the ``Debug``
ids), and ``test_demo_generation``'s expert demos through
``minigrid_tpu_torch/utils/demos.py``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import minigrid_tpu_torch as mgt
from minigrid_tpu_torch.utils.babyai_bot import BabyAIBot, DisappearedBoxError
from minigrid_tpu_torch.utils.demos import generate_demos
from test_torch_babyai_bot import FAST_IDS


def _solve(env, seed: int, max_steps: int = 300) -> bool:
    _, state = env.reset(1, torch.Generator().manual_seed(seed))
    bot = BabyAIBot(env, state)
    action = None
    for _ in range(max_steps):
        action = bot.replan(state, action)
        state, reward = env.step_env(state, torch.tensor([action], dtype=torch.int32))
        if bool(state.terminated[0]):
            return float(reward[0]) > 0
        if bool(state.truncated[0]):
            return False
    return False


@pytest.mark.parametrize("env_id", FAST_IDS)
def test_bot_solves_level(env_id):
    env = mgt.make(env_id)
    need = 1 if "Debug" in env_id else 2
    budget = 12 if "Debug" in env_id else 6
    solved = attempts = seed = 0
    while solved < need and attempts < budget:
        attempts += 1
        try:
            if _solve(env, seed):
                solved += 1
        except DisappearedBoxError:
            pass
        seed += 1
    assert solved >= need, f"{env_id}: bot solved {solved} of {attempts} attempts"


def test_demo_generation():
    env = mgt.make("BabyAI-GoToRedBallGrey-v0")
    demos = generate_demos(env, num_demos=3, start_seed=0, device="cpu")
    assert len(demos) == 3
    for d in demos:
        t = d.actions.shape[0]
        assert d.images.shape == (t, 7, 7, 3) and d.images.dtype == np.uint8
        assert d.directions.shape == (t,) and d.directions.dtype == np.int32
        assert d.missions.shape[0] == t and d.missions.dtype == np.int32
        assert d.actions.dtype == np.int32
        assert d.reward > 0
