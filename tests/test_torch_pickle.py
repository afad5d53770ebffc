"""Pickling conformance of the port (twins of ``tests/test_pickle.py``'s
``test_pickle_env_family`` and ``test_pickle_env_state``; reference:
tests/test_envs.py:174-184, every env pickles and the clone behaves
identically), on the CPU, on the same five ids: an env family, a static
configuration object, and an ``EnvState`` batch, a dataclass of tensors
(BabyAI's instruction state and Dynamic-Obstacles' walk state in its
``extra``)."""

from __future__ import annotations

import pickle

import pytest
import torch

import minigrid_tpu_torch as mgt
from torch_port_util import assert_trees_equal

# tests/test_pickle.py's ids: plain, carrying and doors, RoomGrid, BabyAI
# (mission and verifier planes), and the step-RNG family.
PICKLE_IDS = [
    "MiniGrid-Empty-8x8-v0",
    "MiniGrid-DoorKey-8x8-v0",
    "MiniGrid-KeyCorridorS3R2-v0",
    "BabyAI-GoToLocal-v0",
    "MiniGrid-Dynamic-Obstacles-8x8-v0",
]


@pytest.mark.parametrize("env_id", PICKLE_IDS)
def test_pickle_env_family(env_id):
    env = mgt.make(env_id)
    env2 = pickle.loads(pickle.dumps(env))
    assert type(env2) is type(env)
    obs1, s1 = env.reset(3, torch.Generator().manual_seed(7), "cpu")
    obs2, s2 = env2.reset(3, torch.Generator().manual_seed(7), "cpu")
    assert_trees_equal(obs1, obs2)
    assert_trees_equal(s1, s2)


@pytest.mark.parametrize("env_id", PICKLE_IDS)
def test_pickle_env_state(env_id):
    """An ``EnvState`` batch round-trips through pickle bit for bit, and the
    clone steps as the original does."""
    env = mgt.make(env_id)
    _, state = env.reset(3, torch.Generator().manual_seed(3), "cpu")
    state2 = pickle.loads(pickle.dumps(state))
    assert type(state2) is type(state)
    assert_trees_equal(state, state2)
    actions = torch.tensor([2, 1, 2], dtype=torch.int32)
    n1, r1 = env.step_env(state, actions)
    n2, r2 = env.step_env(state2, actions)
    assert torch.equal(r1, r2)
    assert_trees_equal(n1, n2)
