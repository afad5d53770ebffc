"""The learners size their reset cache from their own chunks
(``rl/rollout.LearnerResets``): a chunk that comes near its R grows the
next chunk's, every reset past R is counted as ``replayed``, and an R the
caller fixed stays fixed.  GoToDoor-5x5 ends an episode about every 3.5
random steps; its table row is patched down so that the first R is too
small."""

from __future__ import annotations

import pytest
import torch

import minigrid_tpu_torch as mgt
from minigrid_tpu_torch.parallel import reset_budget
from minigrid_tpu_torch.rl.impala import IMPALAConfig, make_impala
from minigrid_tpu_torch.rl.ppo import PPOConfig, make_ppo
from torch_port_util import one_torch_thread  # noqa: F401

ENV_ID = "MiniGrid-GoToDoor-5x5-v0"


@pytest.fixture
def small_row(monkeypatch):
    # covering_resets(1, 256) = 3 levels per chunk
    monkeypatch.setitem(reset_budget.MEASURED_MAX_EPISODES_256, ENV_ID, 1)
    return reset_budget.covering_resets(1, 256)


def _replayed(done: torch.Tensor, r: int) -> int:
    return int((done.int().sum(dim=0) - r).clamp(min=0).sum())


@pytest.mark.parametrize("make, config_cls", [(make_ppo, PPOConfig), (make_impala, IMPALAConfig)])
def test_learner_grows_r_after_a_chunk_near_it(small_row, make, config_cls, one_torch_thread):
    env = mgt.make(ENV_ID)
    init_fn, train_step = make(env, config_cls(rollout_steps=16), hidden=16)
    state = init_fn(torch.Generator().manual_seed(0), 32)
    assert train_step.resets.r == small_row == 3

    final, traj = train_step.rollout(state.params, state.env_states, state.generator)
    _, _, metrics = train_step.update(state.params, state.opt_state, final, traj)
    most = int(traj.done.int().sum(dim=0).max())
    assert int(metrics["max_episodes_per_chunk"]) == most > small_row
    assert int(metrics["resets_per_chunk"]) == small_row
    assert int(metrics["replayed"]) == _replayed(traj.done, small_row) > 0
    # The next chunk's cache is drawn at the grown R.
    assert train_step.resets.r == max(2 * most, small_row + 1)

    grown = train_step.resets.r
    final, traj = train_step.rollout(state.params, final, state.generator)
    _, _, metrics = train_step.update(state.params, state.opt_state, final, traj)
    assert int(metrics["resets_per_chunk"]) == grown
    assert int(metrics["replayed"]) == _replayed(traj.done, grown)


def test_an_r_the_caller_gives_stays_fixed(small_row, one_torch_thread):
    env = mgt.make(ENV_ID)
    init_fn, train_step = make_ppo(env, PPOConfig(rollout_steps=16, resets_per_chunk=2), hidden=16)
    state = init_fn(torch.Generator().manual_seed(1), 32)
    for _ in range(2):
        state, metrics = train_step(state)
        assert int(metrics["resets_per_chunk"]) == train_step.resets.r == 2
        assert int(metrics["replayed"]) > 0


def test_families_that_cannot_replay_keep_r_and_report_none(one_torch_thread):
    # Fixed-start Empty's levels are all alike: its R=1 never grows.
    env = mgt.make("MiniGrid-Empty-5x5-v0", max_steps=3)
    init_fn, train_step = make_ppo(env, PPOConfig(rollout_steps=16), hidden=16)
    state = init_fn(torch.Generator().manual_seed(2), 16)
    state, metrics = train_step(state)
    assert int(metrics["max_episodes_per_chunk"]) >= 5
    assert int(metrics["replayed"]) == 0 and train_step.resets.r == int(metrics["resets_per_chunk"]) == 1
