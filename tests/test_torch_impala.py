"""The PyTorch port's IMPALA learner against the JAX package's.

V-trace, the minibatch loss and its gradients, and the metrics of one
update are compared on the same inputs and parameters (nonzero biases); the
learner must also learn Empty-8x8 as the JAX learner does
(tests/test_impala_learning.py).  On the CPU every first layer runs the
plain version of the embed + dense-1 op.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minigrid_tpu as mg
import minigrid_tpu_torch as mgt
from minigrid_tpu.rl import impala as jimpala
from minigrid_tpu.rl.rollout import collect_trajectory as j_collect_trajectory
from minigrid_tpu_torch.rl import impala as timpala
from minigrid_tpu_torch.rl import ppo as tppo
from minigrid_tpu_torch.rl.model import apply_packed_fused
from minigrid_tpu_torch.rl.rollout import Trajectory
from minigrid_tpu_torch.utils.bridge import params_to_flax
from torch_port_util import jax_learner_init, one_torch_thread, port_model, to_port, with_bias_noise  # noqa: F401

HIDDEN = 64
ENV_ID = "MiniGrid-Empty-5x5-v0"


@pytest.mark.parametrize("rho_clip, c_clip, lam", [(1.0, 1.0, 1.0), (1.0, 0.9, 0.95), (0.8, 1.2, 1.0)])
def test_vtrace_matches_jax(rho_clip, c_clip, lam):
    rng = np.random.default_rng(4)
    t, n = 17, 24
    # Log-ratios of +-1 put many importance weights above both clips.
    tl, bl = (rng.normal(0, 0.6, (2, t, n))).astype(np.float32)
    values, rewards = rng.normal(size=(2, t, n)).astype(np.float32)
    boot = rng.normal(size=n).astype(np.float32)
    disc = (0.97 * (rng.random((t, n)) > 0.2)).astype(np.float32)
    assert (np.exp(tl - bl) > max(rho_clip, c_clip)).mean() > 0.2
    args = (tl, bl, values, boot, rewards, disc)
    want = jimpala.vtrace(*(jnp.asarray(x) for x in args), rho_clip, c_clip, lam)
    got = timpala.vtrace(*(torch.from_numpy(x) for x in args), rho_clip, c_clip, lam)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_vtrace_takes_no_gradient():
    t, n = 4, 3
    values = torch.randn(t, n, requires_grad=True)
    logp = torch.randn(t, n, requires_grad=True)
    vs, adv = timpala.vtrace(logp, logp.detach(), values, torch.zeros(n), torch.ones(t, n), torch.full((t, n), 0.9))
    assert not vs.requires_grad and not adv.requires_grad


@pytest.fixture(scope="module")
def jax_case():
    """A JAX IMPALA learner on Empty-5x5 (64 envs x 16 steps, hidden 64,
    nonzero biases, 2 minibatches): its state, the trajectory its train
    step collects (rebuilt from the same key) and that step's metrics."""
    config = jimpala.IMPALAConfig(rollout_steps=16, num_minibatches=2)
    env = mg.make(ENV_ID)
    init_fn, train_step = jimpala.make_impala(env, config, hidden=HIDDEN)
    state = jax_learner_init(init_fn, jax.random.PRNGKey(0), 64)
    state = state._replace(params=jax.tree.map(jnp.asarray, with_bias_noise(jax.tree.map(np.array, state.params), 3)))
    model = jimpala.ActorCritic(hidden=HIDDEN, num_actions=env.num_actions)

    def policy_apply(p, obs, direction):
        return model.apply(p, obs, direction, packed=True)

    env_states, _, traj = j_collect_trajectory(
        env, policy_apply, state.params, state.env_states, key=state.key, rollout_steps=16,
        resets_per_chunk=mg.parallel.reset_budget.resets_for(env, 16), fused_actor=True,
    )
    _, metrics = jax.jit(train_step)(state)
    return config, jax.tree.map(np.array, state.params), env_states, traj, metrics


def _port_traj(traj) -> Trajectory:
    return Trajectory(*(torch.from_numpy(np.array(x)) for x in traj))


def test_update_metrics_match_jax(jax_case):
    config, params, env_states, traj, want = jax_case
    model = port_model(params)
    _, step = timpala.make_impala(mgt.make(ENV_ID), timpala.IMPALAConfig(**config._asdict()), hidden=HIDDEN)
    _, opt_state, got = step.update(model, tppo.adam_init(model), to_port(env_states), _port_traj(traj))
    assert opt_state.count == 2
    # Averages over two minibatches, the second after one Adam step: bf16
    # rounding of the forward moves them by far less than 1e-3.
    for k in ("pg_loss", "value_loss", "entropy"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-3, err_msg=k)
    for k in ("reward_per_step", "episodes", "max_episodes_per_chunk"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("b", [0, 1])  # bootstrapped from the next slice, or from the post-rollout obs
def test_loss_and_gradients_match_jax(jax_case, b):
    config, params, env_states, traj, _ = jax_case
    jenv = mg.make(ENV_ID)
    jmodel = jimpala.ActorCritic(hidden=HIDDEN, num_actions=7)
    mb_t = 16 // config.num_minibatches
    end = (b + 1) * mb_t
    last_obs = jax.vmap(lambda s: jenv.observation_packed(s).reshape(49))(env_states)
    boot = (traj.obs[end], traj.direction[end]) if end < 16 else (last_obs, env_states.agent_dir)
    # Behaviour log-probs moved off the policy, so that the clips act.
    shift = np.random.default_rng(b).normal(0, 0.5, (mb_t,) + traj.logp.shape[1:]).astype(np.float32)
    batch = tuple(np.array(x[b * mb_t : end]) for x in traj[:4]) + tuple(
        np.array(x[b * mb_t : end]) for x in (traj.reward, traj.done)
    ) + tuple(np.array(x) for x in boot)
    batch = batch[:3] + (batch[3] + shift,) + batch[4:]
    obs, direction, action, behavior_logp, reward, done, boot_obs, boot_dir = batch

    def loss_jax(p):
        # minigrid_tpu/rl/impala.py:136-163.
        logits, values = jmodel.apply(p, obs, direction, packed=True)
        _, boot_value = jmodel.apply(p, boot_obs, boot_dir, packed=True)
        logp_all = jax.nn.log_softmax(logits)
        target_logp = jnp.sum(jnp.where(action[..., None] == jnp.arange(7), logp_all, 0.0), axis=-1)
        discounts = config.gamma * (1.0 - done.astype(jnp.float32))
        vs, pg_adv = jimpala.vtrace(
            target_logp, behavior_logp, values, boot_value, reward, discounts,
            config.rho_clip, config.c_clip, config.vtrace_lambda,
        )
        pg = -(target_logp * pg_adv).mean()
        v_loss = 0.5 * jnp.square(values - vs).mean()
        entropy = -(jnp.exp(logp_all) * logp_all).sum(-1).mean()
        return pg + config.value_coef * v_loss - config.entropy_coef * entropy, (pg, v_loss, entropy)

    (want_loss, want_aux), want = jax.value_and_grad(loss_jax, has_aux=True)(jax.tree.map(jnp.asarray, params))
    model = port_model(params)
    _, step = timpala.make_impala(mgt.make(ENV_ID), timpala.IMPALAConfig(**config._asdict()), hidden=HIDDEN)
    loss, aux = step.loss_fn(
        lambda o, d: apply_packed_fused(model, o, d), tuple(torch.from_numpy(np.array(x)) for x in batch)
    )
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-3, atol=1e-5)
    for g, w in zip(aux, want_aux):
        np.testing.assert_allclose(float(g.detach()), float(w), rtol=1e-3, atol=1e-5)
    loss.backward()
    got = params_to_flax({k: p.grad for k, p in model.named_parameters()})
    for a, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(a, w, rtol=0, atol=2e-2 * max(1.0, float(np.abs(w).max())))


@pytest.mark.usefixtures("one_torch_thread")
def test_impala_improves_on_empty():
    # tests/test_impala_learning.py's configuration.
    config = timpala.IMPALAConfig(
        rollout_steps=64, num_minibatches=4, update_epochs=2, learning_rate=1e-3, entropy_coef=0.005
    )
    init_fn, train_step = timpala.make_impala(mgt.make("MiniGrid-Empty-8x8-v0"), config, hidden=HIDDEN)
    state = init_fn(torch.Generator().manual_seed(0), 128)
    rewards = []
    for _ in range(30):
        state, metrics = train_step(state)
        rewards.append(float(metrics["reward_per_step"]))
        assert np.isfinite(rewards[-1]) and np.isfinite(float(metrics["pg_loss"]))
    early, late = float(np.mean(rewards[:5])), float(np.mean(rewards[-5:]))
    assert late > early * 1.5 + 1e-4, f"no learning: early {early:.5f} late {late:.5f}"
    assert late > 0.01, f"final reward/step too low: {late:.5f}"


@pytest.mark.parametrize("learner", ["ppo", "impala"])
def test_learners_train_on_dynamic_obstacles_on_the_cpu(learner):
    env = mgt.make("MiniGrid-Dynamic-Obstacles-5x5-v0")
    if learner == "ppo":
        init_fn, train_step = tppo.make_ppo(env, tppo.PPOConfig(rollout_steps=16, num_minibatches=2), hidden=HIDDEN)
    else:
        init_fn, train_step = timpala.make_impala(env, timpala.IMPALAConfig(rollout_steps=16, num_minibatches=2), hidden=HIDDEN)
    state = init_fn(torch.Generator().manual_seed(2), 64)
    state, metrics = train_step(state)
    assert all(np.isfinite(float(metrics[k])) for k in ("pg_loss", "value_loss", "entropy"))
    # Collisions end episodes at -1 and the counter stream regenerates them.
    assert int(metrics["episodes"]) > 0 and float(metrics["reward_per_step"]) < 0
    assert set(state.env_states.extra) == {"obstacles", "front_not_clear", "walk_seed"}
