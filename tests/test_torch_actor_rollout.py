"""The PyTorch port's actor collection against the JAX package's fused actor
kernel (Pallas, interpret mode), on the contracts of tests/test_actor_rollout.py.

JAX collects on Empty-5x5 (max_steps=8, so episodes truncate and reset
through the cache); the reset cache and the sampling bits are derived from
the same keys the JAX kernel splits (``actor_rollout.py:464-474``) and
carried into the port's layout.  The port is then held to the three
contracts (``ops/actor_rollout.check_trajectory``): its ``step_cached``
replays JAX's trajectory exactly (rewards to rtol 1e-6), its actor gives
JAX's logp and value to atol 2e-2, and its sampler on JAX's bits gives
JAX's action wherever the top two Gumbel scores are more than 1e-2 apart.
The port's own collection on CPU (``actor_rollout_reference``) is held to
the same contracts.
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
from minigrid_tpu_torch.ops import actor_rollout as ar
from minigrid_tpu_torch.utils.bridge import state_from_numpy
from torch_port_util import flax_params, jax_to_numpy, port_model, to_port

N, T, R = 1024, 10, 2  # T > max_steps: every episode ends and resets once
ENV_ID = "MiniGrid-Empty-5x5-v0"


@pytest.fixture(scope="module")
def case():
    env = mg.make(ENV_ID, max_steps=8)
    k_reset, k_param, key = jax.random.split(jax.random.PRNGKey(4), 3)
    _, states = jax.jit(jax.vmap(env.reset))(jax.random.split(k_reset, N))
    packed = jax.vmap(lambda s: env.observation_packed(s).reshape(-1))(states)
    _, params = flax_params(np.asarray(packed), np.asarray(states.agent_dir), seed=int(k_param[1]) % 1000)
    # Wait for the interpreted kernel before dispatching anything else: its
    # host callbacks run JAX ops of their own, which would queue behind a
    # computation dispatched meanwhile and never run.
    final, traj = jax.block_until_ready(j_fused_actor_rollout(env, params, states, key, T, R, interpret=True))
    # The cache and the bits the JAX kernel drew (actor_rollout.py:464-474);
    # bits [Eb, T, 8, B] -> the port's [T, A, N].
    k_cache, k_noise, _ = jax.random.split(key, 3)
    cache = env.batch_reset_cache(k_cache, N, R)
    bits = np.asarray(jax.random.bits(k_noise, (N // JAX_BLOCK, T, HEAD_ROWS, JAX_BLOCK), jnp.uint32).astype(jnp.int32))
    noise = bits.transpose(1, 2, 0, 3).reshape(T, HEAD_ROWS, N)[:, : env.num_actions]
    model = port_model(params)
    return {
        "env": mgt.make(ENV_ID, max_steps=8),
        "model": model,
        "weights": ar.repack_actor_params(model),
        "states": to_port(states),
        "cache": to_port(cache),
        "noise": torch.from_numpy(np.ascontiguousarray(noise)),
        "final": state_from_numpy(jax_to_numpy(final)),
        "traj": {k: torch.from_numpy(np.array(v)) for k, v in traj.items()},
    }


def test_jax_trajectory_meets_the_port_contracts(case):
    traj = case["traj"]
    assert traj["obs"].shape == (T, N, 49) and traj["done"].dtype == torch.bool
    assert int(traj["done"].sum()) > 0, "no resets exercised"
    err, ties = ar.check_trajectory(
        case["env"], case["weights"], case["states"], case["cache"], case["noise"], case["final"], traj
    )
    assert err <= 2e-2 and ties <= 0.01 * T * N


def test_reference_meets_the_same_contracts(case):
    before = ar.KERNEL_LAUNCHES
    final, traj = ar.fused_actor_rollout_core(
        case["env"], case["weights"], case["states"], case["cache"], case["noise"]
    )
    assert ar.KERNEL_LAUNCHES == before  # CPU tensors: the plain version
    assert {k: v.dtype for k, v in traj.items()} == {
        "obs": torch.int32, "direction": torch.int32, "action": torch.int32, "logp": torch.float32,
        "value": torch.float32, "reward": torch.float32, "done": torch.bool,
    }
    assert int(traj["done"].sum()) > 0
    ar.check_trajectory(case["env"], case["weights"], case["states"], case["cache"], case["noise"], final, traj)
    # From the same states, the first step samples JAX's actions wherever
    # they are not near-ties (the bits are JAX's).
    same = (traj["action"][0] == case["traj"]["action"][0]).float().mean()
    assert float(same) >= 0.99
    np.testing.assert_array_equal(traj["obs"][0].numpy(), case["traj"]["obs"][0].numpy())


def test_sampler_is_first_max_gumbel_argmax():
    logits = torch.tensor([[0.0, 0.0, 0.0], [5.0, 0.0, 0.0]])
    # Bits 0x80000000 (top 24 bits 2^23) give u = (2^23 + 0.5) / 2^24 for
    # every action: equal Gumbel noise, so the largest logit wins, and the
    # first of equal ones.
    bits = torch.full((3, 2), -(2**31), dtype=torch.int32)
    action, logp = ar.sample_actions(logits, bits)
    assert action.tolist() == [0, 0]
    np.testing.assert_allclose(logp.numpy(), torch.log_softmax(logits, -1)[:, 0].numpy(), rtol=0, atol=1e-6)
    # Negative int32 bits count as unsigned: 0xFFFFFF00 gives u near 1, the
    # largest Gumbel score, for action 1 only.
    bits[1] = -256
    assert ar.sample_actions(logits, bits)[0].tolist() == [1, 1]


def test_fused_actor_rollout_draws_cache_then_bits(case):
    env, model = case["env"], case["model"]
    gen = torch.Generator().manual_seed(7)
    n = 64
    _, states = env.reset(n, gen)
    snapshot = gen.get_state()
    final, traj = ar.fused_actor_rollout(env, model, states, gen, 5, R)
    gen.set_state(snapshot)
    cache = env.batch_reset_cache(n, R, gen)
    noise = ar.draw_bits(gen, (5, env.num_actions, n), None)
    want_final, want = ar.actor_rollout_reference(env, ar.repack_actor_params(model), states, cache, noise)
    for k in want:
        assert torch.equal(traj[k], want[k]), k
    assert torch.equal(final.grid, want_final.grid)


def test_cpu_is_not_eligible():
    env = mgt.make(ENV_ID)
    assert not ar.supports_fused_actor(env, "cpu", 1024, 256)
