"""The port's checkpoints (``minigrid_tpu_torch/utils/checkpoint.py``) on the
CPU: state batches round-trip through ``.npz``, a PPO ``TrainState`` resumes
bit for bit, and files cross between the two packages (their entries are
keyed by ``jax.tree_util.keystr`` paths in both)."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

import minigrid_tpu as mg
import minigrid_tpu_torch as mgt
from babyai_port_util import to_port as babyai_to_port
from minigrid_tpu.utils import checkpoint as jax_checkpoint
from minigrid_tpu_torch.rl.model import ActorCritic
from minigrid_tpu_torch.rl.ppo import PPOConfig, make_ppo
from minigrid_tpu_torch.utils import checkpoint
from minigrid_tpu_torch.utils.bridge import params_from_flax, params_to_flax
from torch_port_util import HIDDEN, assert_states_equal, assert_trees_equal, flax_params, observations


def stepped_states(env_id: str, n: int = 4, steps: int = 5):
    """``n`` envs of ``env_id`` after a few random steps, on the CPU."""
    env = mgt.make(env_id)
    gen = torch.Generator().manual_seed(11)
    _, states = env.reset(n, gen, "cpu")
    for _ in range(steps):
        actions = torch.randint(0, env.num_actions, (n,), generator=gen, dtype=torch.int32)
        _, states, *_ = env.step(states, actions, gen)
    return states


@pytest.mark.parametrize("env_id", ["MiniGrid-DoorKey-8x8-v0", "BabyAI-GoToLocal-v0"])
def test_npz_round_trip(tmp_path, env_id):
    states = stepped_states(env_id)
    path = str(tmp_path / "states.npz")
    checkpoint.save_npz(path, states)
    restored = checkpoint.load_npz(path, states)
    assert_trees_equal(restored, states)
    with np.load(path) as z:
        keys = z.files
    assert ".grid" in keys
    if states.extra is not None:
        assert type(restored.extra["instr"]) is type(states.extra["instr"])
        assert ".extra['instr'].gridm" in keys


def test_load_names_missing_leaves(tmp_path):
    states = stepped_states("MiniGrid-DoorKey-8x8-v0")
    path = str(tmp_path / "partial.npz")
    checkpoint.save_npz(path, {"grid": states.grid})
    with pytest.raises(KeyError, match=r"\.agent_x"):
        checkpoint.load_npz(path, states)


def test_train_state_checkpoint_resume_bitexact(tmp_path):
    """A PPO train state saved after one step and loaded into a learner
    built anew (as a resumed process builds it) continues exactly as the
    uninterrupted run: metrics, parameters, optimizer, envs and generator."""
    env = mgt.make("MiniGrid-Empty-5x5-v0")
    config = PPOConfig(rollout_steps=16, num_minibatches=2)
    init_fn, train_step = make_ppo(env, config, hidden=32)
    state = init_fn(torch.Generator().manual_seed(3), num_envs=16)
    state, _ = train_step(state)

    path = str(tmp_path / "trainstate")
    checkpoint.save(path, state)
    resumed = checkpoint.load(path, state)
    assert resumed.params is not state.params and resumed.generator is not state.generator
    assert resumed.opt_state.count == state.opt_state.count == 2

    _, resumed_step = make_ppo(env, config, hidden=32)
    cont, m_cont = train_step(state)
    res, m_res = resumed_step(resumed)
    for k in m_cont:
        assert torch.equal(m_cont[k], m_res[k]), k
    assert_trees_equal(dict(res.params.state_dict()), dict(cont.params.state_dict()))
    assert res.opt_state.count == cont.opt_state.count
    assert_trees_equal((res.opt_state.mu, res.opt_state.nu), (cont.opt_state.mu, cont.opt_state.nu))
    assert_trees_equal(res.env_states, cont.env_states)
    assert torch.equal(res.generator.get_state(), cont.generator.get_state())


def test_jax_state_file_loads_in_the_port(tmp_path):
    """JAX's ``save_npz`` of a vmapped GoToLocal batch loads through the
    port's ``load_npz`` into the state the bridge makes of it (JAX's
    ``.rng`` is left unread)."""
    env = mg.make("BabyAI-GoToLocal-v0")
    _, jstates = jax.jit(jax.vmap(env.reset))(jax.random.split(jax.random.PRNGKey(5), 3))
    path = str(tmp_path / "jax_states.npz")
    jax_checkpoint.save_npz(path, jstates)
    want = babyai_to_port(jstates)
    like = stepped_states("BabyAI-GoToLocal-v0", n=3, steps=1)
    assert_trees_equal(checkpoint.load_npz(path, like), want)


def test_port_save_loads_in_jax(tmp_path):
    """The port's ``save`` is read back by JAX's ``load`` (which reads
    ``<path>.npz`` first), every leaf but JAX's ``rng``, which the port's
    state has not."""
    states = stepped_states("BabyAI-GoToLocal-v0", n=3)
    path = str(tmp_path / "port_states")
    checkpoint.save(path, states)
    env = mg.make("BabyAI-GoToLocal-v0")
    _, like = jax.jit(jax.vmap(env.reset))(jax.random.split(jax.random.PRNGKey(0), 3))
    restored = jax_checkpoint.load(path, dataclasses.replace(like, rng=None))
    assert_states_equal(states, restored, "JAX's load of the port's save")


def test_jax_params_file_loads_into_actor_critic(tmp_path):
    """JAX's ``save_npz`` of flax PPO parameters loads into the port's
    ``ActorCritic`` through ``utils/bridge.params_from_flax``: the weights
    bit for bit, the forward within ``tests/test_torch_model.py``'s atol."""
    packed, direction = observations(32)
    jm, params = flax_params(packed, direction)
    path = str(tmp_path / "params.npz")
    jax_checkpoint.save_npz(path, params)
    model = ActorCritic(hidden=HIDDEN, num_actions=7, device="cpu")
    like = jax.tree.map(torch.from_numpy, params_to_flax(model.state_dict()))
    model.load_state_dict(params_from_flax(checkpoint.load_npz(path, like)))
    for name, value in params_from_flax(params).items():
        assert torch.equal(model.state_dict()[name], value), name
    want_logits, want_value = jm.apply(params, packed, direction, packed=True)
    with torch.no_grad():
        logits, value = model(torch.from_numpy(packed), torch.from_numpy(direction), packed=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=0, atol=2e-2)
    np.testing.assert_allclose(value.numpy(), np.asarray(want_value), rtol=0, atol=2e-2)
