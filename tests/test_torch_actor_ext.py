"""The PyTorch port's actor collection on a counter-reset family against the
JAX package's fused actor kernel (Pallas, interpret mode).

JAX collects on Dynamic-Obstacles-5x5, whose kernel runs the family's ext:
the obstacle walk before every action, the >= 3 -> left remap (the
trajectory keeps the sampled action), the collision penalty, and a fresh
level from the counter stream at every episode end.  The per-env reset
seeds and the sampling bits are rebuilt from the keys the JAX kernel splits
(``minigrid_tpu/ops/actor_rollout.py:464-474``) and carried into the port's
layout.  The port is then held to the three contracts
(``ops/actor_rollout.check_trajectory`` with the seeds): replaying JAX's
actions through the port's step and counter reset gives its obs, direction,
done and final state exactly, ``extra`` included, and its reward to rtol
1e-6 (XLA's FMA); the port's actor gives JAX's logp and value to atol 2e-2
(bf16); its sampler on JAX's bits gives JAX's action wherever the top two
Gumbel scores are more than 1e-2 apart.  The port's own collection on CPU
(``actor_rollout_reference``) is held to the same contracts.
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
from minigrid_tpu_torch.ops.prng import draw_seeds
from minigrid_tpu_torch.utils.bridge import state_from_numpy
from torch_port_util import flax_params, jax_to_numpy, port_model, to_port

N, T = 1024, 5
ENV_ID = "MiniGrid-Dynamic-Obstacles-5x5-v0"


@pytest.fixture(scope="module")
def case():
    env = mg.make(ENV_ID)
    k_reset, k_param, key = jax.random.split(jax.random.PRNGKey(3), 3)
    _, states = jax.jit(jax.vmap(env.reset))(jax.random.split(k_reset, N))
    packed = jax.vmap(lambda s: env.observation_packed(s).reshape(-1))(states)
    _, params = flax_params(np.asarray(packed), np.asarray(states.agent_dir), seed=int(k_param[1]) % 1000)
    # Wait for the interpreted kernel before dispatching anything else: its
    # host callbacks run JAX ops of their own.
    final, traj = jax.block_until_ready(j_fused_actor_rollout(env, params, states, key, T, 2, interpret=True))
    # The seeds and the bits the JAX kernel drew; bits [Eb, T, 8, B] -> the
    # port's [T, A, N].
    k_cache, k_noise, _ = jax.random.split(key, 3)
    seeds = np.array(jax.random.bits(k_cache, (N, 2), jnp.uint32).astype(jnp.int32))
    bits = np.asarray(jax.random.bits(k_noise, (N // JAX_BLOCK, T, HEAD_ROWS, JAX_BLOCK), jnp.uint32).astype(jnp.int32))
    noise = bits.transpose(1, 2, 0, 3).reshape(T, HEAD_ROWS, N)[:, : env.num_actions]
    model = port_model(params)
    return {
        "env": mgt.make(ENV_ID),
        "model": model,
        "weights": ar.repack_actor_params(model),
        "states": to_port(states),
        "seeds": torch.from_numpy(seeds),
        "noise": torch.from_numpy(np.ascontiguousarray(noise)),
        "final": state_from_numpy(jax_to_numpy(final)),
        "traj": {k: torch.from_numpy(np.array(v)) for k, v in traj.items()},
    }


def _check(case, final, traj):
    return ar.check_trajectory(
        case["env"], case["weights"], case["states"], None, case["noise"], final, traj,
        reset_seeds=case["seeds"],
    )


def test_jax_trajectory_meets_the_port_contracts(case):
    traj = case["traj"]
    assert traj["obs"].shape == (T, N, 49) and traj["done"].dtype == torch.bool
    assert set(case["final"].extra) == {"obstacles", "front_not_clear", "walk_seed"}
    err, ties = _check(case, case["final"], traj)
    assert err <= 2e-2 and ties <= 0.01 * T * N
    # The remap leaves actions >= 3 in the trajectory; collisions cost -1
    # and end the episode, which the counter stream then regenerates.
    assert int((traj["action"] >= 3).sum()) > 0
    assert float(traj["reward"].min()) == -1.0
    assert int(traj["done"].sum()) > 0


def test_reference_meets_the_same_contracts(case):
    before = ar.KERNEL_LAUNCHES
    final, traj = ar.fused_actor_rollout_core(
        case["env"], case["weights"], case["states"], None, case["noise"], case["seeds"]
    )
    assert ar.KERNEL_LAUNCHES == before  # CPU tensors: the plain version
    assert int(traj["done"].sum()) > 0 and float(traj["reward"].min()) == -1.0
    _check(case, final, traj)
    # From the same states, the first step samples JAX's actions wherever
    # they are not near-ties (the bits are JAX's).
    same = (traj["action"][0] == case["traj"]["action"][0]).float().mean()
    assert float(same) >= 0.99
    np.testing.assert_array_equal(traj["obs"][0].numpy(), case["traj"]["obs"][0].numpy())


def test_contracts_compare_the_final_extra(case):
    final = case["final"]
    extra = dict(final.extra, walk_seed=final.extra["walk_seed"] ^ 1)
    with pytest.raises(AssertionError, match="final extra walk_seed"):
        _check(case, final.replace(extra=extra), case["traj"])
    with pytest.raises(ValueError, match="reset_seeds"):
        ar.check_trajectory(
            case["env"], case["weights"], case["states"], None, case["noise"], final, case["traj"]
        )


@pytest.mark.parametrize(
    "env_id", ["MiniGrid-Empty-Random-5x5-v0", "MiniGrid-LavaCrossingS9N2-v0", "MiniGrid-Dynamic-Obstacles-5x5-v0"]
)
def test_fused_actor_rollout_draws_seeds_then_bits(case, env_id):
    env, model = mgt.make(env_id), case["model"]
    gen = torch.Generator().manual_seed(5)
    n, t = 64, 6
    _, states = env.reset(n, gen)
    snapshot = gen.get_state()
    final, traj = ar.fused_actor_rollout(env, model, states, gen, t)
    gen.set_state(snapshot)
    seeds = draw_seeds(gen, n, "cpu")
    noise = ar.draw_bits(gen, (t, env.num_actions, n), None)
    want_final, want = ar.actor_rollout_reference(env, ar.repack_actor_params(model), states, None, noise, seeds)
    for k in want:
        assert torch.equal(traj[k], want[k]), k
    assert torch.equal(final.grid, want_final.grid)
    assert (final.extra is None) == (env.fused_ext.n_scalars == 0)
    for k, v in (want_final.extra or {}).items():
        assert torch.equal(final.extra[k], v), k
