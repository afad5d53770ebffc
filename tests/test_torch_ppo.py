"""The PyTorch port's PPO learner against the JAX package's.

GAE, the loss metrics of one update, the loss gradients and the optimizer
step are compared on the same inputs and parameters; the learner must also
learn Empty-8x8 as the JAX learner does (tests/test_ppo_learning.py).  On
the CPU every first layer runs the plain version of the embed + dense-1 op.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import minigrid_tpu as mg
import minigrid_tpu_torch as mgt
from minigrid_tpu.rl import ppo as jppo
from minigrid_tpu_torch.rl import ppo as tppo
from minigrid_tpu_torch.rl.model import apply_packed_fused
from minigrid_tpu_torch.rl.rollout import Trajectory
from minigrid_tpu_torch.utils.bridge import params_from_flax, params_to_flax
from torch_port_util import jax_learner_init, one_torch_thread, port_model, to_port, with_bias_noise  # noqa: F401

HIDDEN = 64


def test_gae_matches_jax():
    gamma, lam, t, n = 0.99, 0.95, 32, 16
    rng = np.random.default_rng(3)
    values, rewards = rng.normal(size=(2, t, n)).astype(np.float32)
    dones = rng.random((t, n)) < 0.25
    last = rng.normal(size=n).astype(np.float32)
    config = dict(gamma=gamma, gae_lambda=lam, rollout_steps=t)
    _, jstep = jppo.make_ppo(mg.make("MiniGrid-Empty-5x5-v0"), jppo.PPOConfig(**config))
    _, tstep = tppo.make_ppo(mgt.make("MiniGrid-Empty-5x5-v0"), tppo.PPOConfig(**config))
    want = jstep.gae(jnp.asarray(values), jnp.asarray(rewards), jnp.asarray(dones), jnp.asarray(last))
    got = tstep.gae(*(torch.from_numpy(x) for x in (values, rewards, dones, last)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=1e-5)


@pytest.fixture(scope="module")
def jax_batch():
    """A JAX learner's trajectory on Empty-5x5 (64 envs x 16 steps, hidden
    64, nonzero biases), with the behaviour logp moved off the policy so that the clipped
    ratio is exercised, and its update's metrics (one minibatch)."""
    config = jppo.PPOConfig(rollout_steps=16, num_minibatches=1)
    init_fn, step = jppo.make_ppo(mg.make("MiniGrid-Empty-5x5-v0"), config, hidden=HIDDEN)
    state = jax_learner_init(init_fn, jax.random.PRNGKey(0), 64)
    state = state._replace(params=jax.tree.map(jnp.asarray, with_bias_noise(jax.tree.map(np.array, state.params), 0)))
    env_states, key, traj = step.rollout(state.params, state.env_states, state.key)
    shift = np.random.default_rng(1).normal(0, 0.3, traj.logp.shape).astype(np.float32)
    traj = traj._replace(logp=traj.logp + shift)
    _, _, _, metrics = step.update(state.params, state.opt_state, key, env_states, traj)
    return config, jax.tree.map(np.array, state.params), env_states, traj, metrics


def _port_traj(traj) -> Trajectory:
    return Trajectory(*(torch.from_numpy(np.array(x)) for x in traj))


def test_update_metrics_match_jax(jax_batch):
    config, params, env_states, traj, want = jax_batch
    model = port_model(params)
    _, step = tppo.make_ppo(mgt.make("MiniGrid-Empty-5x5-v0"), tppo.PPOConfig(**config._asdict()), hidden=HIDDEN)
    _, opt_state, got = step.update(model, tppo.adam_init(model), to_port(env_states), _port_traj(traj))
    assert opt_state.count == 1
    for k in ("pg_loss", "value_loss", "entropy"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-3, err_msg=k)
    for k in ("reward_per_step", "episodes", "max_episodes_per_chunk"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)


def test_loss_gradients_match_jax(jax_batch):
    config, params, env_states, traj, _ = jax_batch
    jmodel = jppo.ActorCritic(hidden=HIDDEN, num_actions=7)
    _, jstep = jppo.make_ppo(mg.make("MiniGrid-Empty-5x5-v0"), config, hidden=HIDDEN)
    v = 7
    last_obs = jax.vmap(lambda s: mg.make("MiniGrid-Empty-5x5-v0").observation_packed(s).reshape(v * v))(env_states)
    _, last_value = jmodel.apply(params, last_obs, env_states.agent_dir, packed=True)
    adv = jstep.gae(traj.value, traj.reward, traj.done, last_value)
    batch = (traj.obs, traj.direction, traj.action, traj.logp, adv, adv + traj.value)

    def loss_jax(p):
        # minigrid_tpu/rl/ppo.py:144-163.
        obs, direction, action, old_logp, a, target = batch
        logits, value = jmodel.apply(p, obs, direction, packed=True)
        logp_all = jax.nn.log_softmax(logits)
        logp = jnp.sum(jnp.where(action[..., None] == jnp.arange(7), logp_all, 0.0), axis=-1)
        ratio = jnp.exp(logp - old_logp)
        adv_n = (a - a.mean()) / (a.std() + 1e-8)
        pg = -jnp.minimum(ratio * adv_n, jnp.clip(ratio, 1 - config.clip_eps, 1 + config.clip_eps) * adv_n).mean()
        v_loss = 0.5 * jnp.square(value - target).mean()
        entropy = -(jnp.exp(logp_all) * logp_all).sum(-1).mean()
        return pg + config.value_coef * v_loss - config.entropy_coef * entropy

    want = jax.grad(loss_jax)(jax.tree.map(jnp.asarray, params))
    model = port_model(params)
    _, tstep = tppo.make_ppo(mgt.make("MiniGrid-Empty-5x5-v0"), tppo.PPOConfig(**config._asdict()), hidden=HIDDEN)
    loss, _ = tstep.loss_fn(
        lambda o, d: apply_packed_fused(model, o, d), tuple(torch.from_numpy(np.array(x)) for x in batch)
    )
    loss.backward()
    got = params_to_flax({k: p.grad for k, p in model.named_parameters()})
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-2 * max(1.0, float(np.abs(b).max())))


@pytest.mark.parametrize("grad_scale", [0.001, 1.0])  # clipping off, on
def test_optimizer_matches_optax(jax_batch, grad_scale):
    _, params, _, _, _ = jax_batch
    rng = np.random.default_rng(2)
    grads = [
        jax.tree.map(lambda x: (rng.normal(size=x.shape) * grad_scale).astype(np.float32), params)
        for _ in range(3)
    ]
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(1e-3, eps=1e-5))
    want = jax.tree.map(jnp.asarray, params)
    opt = tx.init(want)
    for g in grads:
        updates, opt = tx.update(g, opt, want)
        want = optax.apply_updates(want, updates)
    model = port_model(params)
    state = tppo.adam_init(model)
    for g in grads:
        state = tppo.apply_gradients(model, params_from_flax(g), state, 1e-3, 0.5)
    assert state.count == 3
    got = params_to_flax(model.state_dict())
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-8)


@pytest.mark.usefixtures("one_torch_thread")
def test_ppo_improves_on_empty():
    config = tppo.PPOConfig(
        rollout_steps=64, num_minibatches=4, update_epochs=2, learning_rate=1e-3, entropy_coef=0.005
    )
    init_fn, train_step = tppo.make_ppo(mgt.make("MiniGrid-Empty-8x8-v0"), config, hidden=HIDDEN)
    state = init_fn(torch.Generator().manual_seed(0), 128)
    rewards = []
    for _ in range(30):
        state, metrics = train_step(state)
        rewards.append(float(metrics["reward_per_step"]))
        assert np.isfinite(rewards[-1]) and np.isfinite(float(metrics["pg_loss"]))
    early, late = float(np.mean(rewards[:5])), float(np.mean(rewards[-5:]))
    assert late > early * 1.5 + 1e-4, f"no learning: early {early:.5f} late {late:.5f}"
    assert late > 0.01, f"final reward/step too low: {late:.5f}"


def test_make_train_loop_and_lr_anneal():
    env = mgt.make("MiniGrid-Empty-5x5-v0")
    train = tppo.make_train(env, tppo.PPOConfig(rollout_steps=16, num_minibatches=2, lr_anneal_updates=2), hidden=32)
    state, metrics = train(torch.Generator().manual_seed(1), 32, 3)
    assert metrics["reward_per_step"].shape == (3,)
    assert torch.isfinite(metrics["pg_loss"]).all()
    assert state.env_states.step_count.shape == (32,)
    assert state.opt_state.count == 6
    # The learning rate reached 0 after 2 updates of 2 minibatches: the
    # third update leaves the parameters as they were.
    before = {k: p.clone() for k, p in state.params.named_parameters()}
    _, train_step = tppo.make_ppo(env, tppo.PPOConfig(rollout_steps=16, num_minibatches=2, lr_anneal_updates=2), hidden=32)
    state, _ = train_step(state)
    assert all(torch.equal(p, before[k]) for k, p in state.params.named_parameters())
