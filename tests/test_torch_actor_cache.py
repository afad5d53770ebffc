"""The PyTorch port's learner on the reset-cache families against the JAX
package's.

* The actor collection: JAX's fused actor kernel (Pallas, interpret mode)
  collects on DoorKey-5x5 (no ext: keys, the locked door, occlusion), on
  GoToDoor-5x5 (the cached ext: the target blended from the reset cache,
  ``done`` and ``toggle`` ending episodes) and on KeyCorridorS3R1 (the
  pickup-target ext on a RoomGrid level), at hidden 64 with nonzero
  biases.  The reset cache (``extra`` included) and the sampling bits are
  rebuilt from the keys the JAX kernel splits
  (``minigrid_tpu/ops/actor_rollout.py:464-474``) and carried into the
  port's layout; JAX's trajectory and the port's own plain collection are
  held to the three contracts of ``ops/actor_rollout.check_trajectory``
  (env replay exact with the final ``extra``, rewards to rtol 1e-6; logp
  and value to atol 2e-2, bf16; sampled actions equal away from near-ties).
* One PPO update on a JAX learner's DoorKey-5x5 trajectory: the loss
  metrics to rtol 1e-3 (bf16), the counts exactly, as
  tests/test_torch_ppo.py does on Empty.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minigrid_tpu as mg
import minigrid_tpu_torch as mgt
from minigrid_tpu.ops.actor_rollout import B as JAX_BLOCK
from minigrid_tpu.ops.actor_rollout import HEAD_ROWS
from minigrid_tpu.ops.actor_rollout import fused_actor_rollout as j_fused_actor_rollout
from minigrid_tpu.rl import ppo as jppo
from minigrid_tpu_torch.ops import actor_rollout as ar
from minigrid_tpu_torch.rl import ppo as tppo
from minigrid_tpu_torch.rl.rollout import Trajectory
from minigrid_tpu_torch.utils.bridge import state_from_numpy
from torch_port_util import HIDDEN, flax_params, jax_learner_init, jax_to_numpy, port_model, to_port, with_bias_noise

N, T, R = 1024, 8, 2  # T > max_steps: every env ends an episode
MAX_STEPS = 5
# KeyCorridor: the pickup-target ext, its kind by value and its color
# blended from the cache, on a RoomGrid level.
ACTOR_IDS = ["MiniGrid-DoorKey-5x5-v0", "MiniGrid-GoToDoor-5x5-v0", "MiniGrid-KeyCorridorS3R1-v0"]


@pytest.fixture(scope="module", params=ACTOR_IDS)
def case(request):
    env_id = request.param
    env = mg.make(env_id, max_steps=MAX_STEPS)
    k_reset, k_param, key = jax.random.split(jax.random.PRNGKey(4), 3)
    _, states = jax.jit(jax.vmap(env.reset))(jax.random.split(k_reset, N))
    packed = jax.vmap(lambda s: env.observation_packed(s).reshape(-1))(states)
    _, params = flax_params(np.asarray(packed), np.asarray(states.agent_dir), seed=int(k_param[1]) % 1000)
    # Wait for the interpreted kernel before dispatching anything else: its
    # host callbacks run JAX ops of their own.
    final, traj = jax.block_until_ready(j_fused_actor_rollout(env, params, states, key, T, R, interpret=True))
    k_cache, k_noise, _ = jax.random.split(key, 3)
    cache = env.batch_reset_cache(k_cache, N, R)
    bits = np.asarray(jax.random.bits(k_noise, (N // JAX_BLOCK, T, HEAD_ROWS, JAX_BLOCK), jnp.uint32).astype(jnp.int32))
    noise = bits.transpose(1, 2, 0, 3).reshape(T, HEAD_ROWS, N)[:, : env.num_actions]
    model = port_model(params)
    return {
        "id": env_id,
        "env": mgt.make(env_id, max_steps=MAX_STEPS),
        "weights": ar.repack_actor_params(model),
        "states": to_port(states),
        "cache": to_port(cache),
        "noise": torch.from_numpy(np.ascontiguousarray(noise)),
        "final": state_from_numpy(jax_to_numpy(final)),
        "traj": {k: torch.from_numpy(np.array(v)) for k, v in traj.items()},
    }


def _check(case, final, traj):
    return ar.check_trajectory(
        case["env"], case["weights"], case["states"], case["cache"], case["noise"], final, traj
    )


def test_jax_trajectory_meets_the_port_contracts(case):
    traj = case["traj"]
    assert traj["obs"].shape == (T, N, 49) and int(traj["done"].sum()) >= N
    err, ties = _check(case, case["final"], traj)
    assert err <= 2e-2 and ties <= 0.01 * T * N
    if case["id"].startswith("MiniGrid-GoToDoor"):
        # The target came from the cache at every reset, and done/toggle
        # ended episodes before truncation.
        assert set(case["final"].extra) == {"target_pos"}
        assert int(traj["done"].sum()) > 2 * N


def test_reference_meets_the_same_contracts(case):
    before = ar.KERNEL_LAUNCHES
    final, traj = ar.fused_actor_rollout_core(case["env"], case["weights"], case["states"], case["cache"], case["noise"])
    assert ar.KERNEL_LAUNCHES == before  # CPU tensors: the plain version
    _check(case, final, traj)
    same = (traj["action"][0] == case["traj"]["action"][0]).float().mean()
    assert float(same) >= 0.99
    np.testing.assert_array_equal(traj["obs"][0].numpy(), case["traj"]["obs"][0].numpy())


def test_contracts_compare_the_final_state_and_extra(case):
    final = case["final"]
    if final.extra is None:
        wrong, field = final.replace(agent_dir=(final.agent_dir + 1) % 4), "final state field agent_dir"
    else:
        key = sorted(final.extra)[0]
        wrong, field = final.replace(extra={**final.extra, key: final.extra[key] + 1}), f"final extra {key}"
    with pytest.raises(AssertionError, match=field):
        _check(case, wrong, case["traj"])


def test_ppo_update_on_doorkey_matches_jax():
    env_id = "MiniGrid-DoorKey-5x5-v0"
    config = jppo.PPOConfig(rollout_steps=16, num_minibatches=1)
    init_fn, step = jppo.make_ppo(mg.make(env_id, max_steps=12), config, hidden=HIDDEN)
    state = jax_learner_init(init_fn, jax.random.PRNGKey(2), 64)
    params = with_bias_noise(jax.tree.map(np.array, state.params), 2)
    env_states, key, traj = step.rollout(jax.tree.map(jnp.asarray, params), state.env_states, state.key)
    shift = np.random.default_rng(3).normal(0, 0.3, traj.logp.shape).astype(np.float32)
    traj = traj._replace(logp=traj.logp + shift)
    _, _, _, want = step.update(jax.tree.map(jnp.asarray, params), state.opt_state, key, env_states, traj)
    assert int(want["episodes"]) > 0  # truncations reset through JAX's cache
    model = port_model(params)
    _, tstep = tppo.make_ppo(mgt.make(env_id, max_steps=12), tppo.PPOConfig(**config._asdict()), hidden=HIDDEN)
    port_traj = Trajectory(*(torch.from_numpy(np.array(x)) for x in traj))
    _, opt_state, got = tstep.update(model, tppo.adam_init(model), to_port(env_states), port_traj)
    assert opt_state.count == 1
    for k in ("pg_loss", "value_loss", "entropy"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-3, err_msg=k)
    for k in ("reward_per_step", "episodes", "max_episodes_per_chunk"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)
