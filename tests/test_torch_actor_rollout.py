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


def test_tiled_weights_give_the_plain_and_jax_policy(case):
    # The kernel's layouts (W1 padded to whole one-hot words and split hi +
    # lo, the heads padded to 8 rows) hold the weights exactly: the padded
    # product equals the unpadded one, and the weights read back give the
    # plain actor's logits and value, and JAX's logp and value on JAX's
    # trajectory.
    weights, traj = case["weights"], case["traj"]
    tiles = ar.tile_actor_weights(weights, 7)
    assert ar.onehot_words(7) == 31
    assert tiles.w1.shape == (62, 2, 8, 2, 8, 8) and tiles.w2.shape == weights.w2.shape
    assert tiles.wh.shape == (4, 1, 2, 8, 8)
    hi, lo = ar.untile_b(tiles.w1[:, 0]), ar.untile_b(tiles.w1[:, 1])
    w1 = hi.double() + lo.double()
    assert torch.equal(w1[:984], weights.w1.double()) and not w1[984:].any()
    assert not (hi.double() * 2.0**16).frac().any() and bool((lo.double().abs() < 2.0**-16).all())
    assert torch.equal(tiles.w2, weights.w2)
    wh = ar.untile_b(tiles.wh).t()
    assert torch.equal(wh[: weights.wh.shape[0]], weights.wh) and not wh[weights.wh.shape[0] :].any()
    from minigrid_tpu_torch.rl.model import embed_obs_packed

    obs, direction, action = traj["obs"].reshape(-1, 49), traj["direction"].reshape(-1), traj["action"].reshape(-1)
    x = embed_obs_packed(obs, direction).double()
    padded = torch.nn.functional.pad(x, (0, w1.shape[0] - x.shape[1])) @ w1
    assert torch.equal(padded, x @ weights.w1.double())
    read_back = weights._replace(w1=w1[:984].to(torch.bfloat16), wh=wh[: weights.wh.shape[0]])
    with torch.no_grad():
        logits, value = ar.actor_policy_reference(read_back, obs, direction)
        want_logits, want_value = ar.actor_policy_reference(weights, obs, direction)
    assert torch.equal(logits, want_logits) and torch.equal(value, want_value)
    logp = torch.log_softmax(logits, dim=-1).gather(1, action.long()[:, None])[:, 0]
    np.testing.assert_allclose(logp.numpy(), traj["logp"].reshape(-1).numpy(), rtol=0, atol=2e-2)
    np.testing.assert_allclose(value.numpy(), traj["value"].reshape(-1).numpy(), rtol=0, atol=2e-2)


@pytest.mark.parametrize("shape", [(16, 8), (32, 64), (992, 256), (256, 8)])
def test_tile_b_puts_each_element_in_its_core_matrix(shape):
    k, n = shape
    b = torch.arange(k * n, dtype=torch.float32).reshape(k, n)
    flat = ar.tile_b(b).reshape(-1)
    kk, nn = torch.meshgrid(torch.arange(k), torch.arange(n), indexing="ij")
    # hopper.cuh: (k, n) at tile k/16, ((n/8)*2 + (k%16)/8)*64 + (n%8)*8 + k%8.
    at = (kk // 16) * (16 * n) + ((nn // 8) * 2 + (kk % 16) // 8) * 64 + (nn % 8) * 8 + kk % 8
    assert torch.equal(flat[at.reshape(-1)], b.reshape(-1))
    assert torch.equal(ar.untile_b(ar.tile_b(b)), b)


def test_split_w1_sums_are_exact_in_float32():
    # hi + lo is W1 exactly; sums of up to 148 hi values or of 148 lo values
    # (as a one-hot row selects) are exact in float32, so hi-sum + lo-sum
    # rounded once is the exact sum rounded once, as the plain actor's
    # float64 layer 1 gives it, tiny weights included.
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.032, (984, 64))
    w[rng.random(w.shape) < 0.01] *= 1e-4  # tiny weights, as training leaves some
    w1 = torch.from_numpy(w).to(torch.bfloat16)
    hi, lo = ar.split_w1(w1)
    assert torch.equal(hi.double() + lo.double(), w1.double())
    rows = torch.from_numpy(rng.integers(0, 984, (512, 148)))
    exact = w1.double()[rows].sum(dim=1)
    hi_sum = hi.float()[rows].sum(dim=1)
    lo_sum = lo.float()[rows].sum(dim=1)
    assert torch.equal(hi_sum.double(), hi.double()[rows].sum(dim=1))
    assert torch.equal(lo_sum.double(), lo.double()[rows].sum(dim=1))
    assert torch.equal(hi_sum + lo_sum, exact.float())


class _Shape:
    def __init__(self, width=8, height=8, num_actions=7, agent_view_size=7):
        self.width, self.height, self.num_actions = width, height, num_actions
        self.agent_view_size = agent_view_size


@pytest.mark.parametrize(
    "n, hidden, env, accepted",
    [
        (32, 64, _Shape(), True),
        (96, 256, _Shape(), True),
        (8192, 256, _Shape(), True),
        (8224, 64, _Shape(), True),
        (0, 256, _Shape(), True),
        (48, 256, _Shape(), False),
        (8200, 256, _Shape(), False),
        (64, 128, _Shape(), True),
        (64, 96, _Shape(), True),
        (64, 32, _Shape(), True),
        (64, 512, _Shape(), True),
        (64, 100, _Shape(), False),
        (64, 544, _Shape(), False),
        (64, 1024, _Shape(), False),
        (64, 64, _Shape(agent_view_size=3), True),
        (64, 64, _Shape(agent_view_size=31), True),
        (64, 64, _Shape(agent_view_size=33), False),
        (64, 256, _Shape(25, 25), True),
        (64, 256, _Shape(26, 25), False),
        (64, 256, _Shape(num_actions=1), True),
        (64, 256, _Shape(num_actions=8), False),
    ],
)
def test_actor_kernel_takes_the_same_shapes(monkeypatch, n, hidden, env, accepted):
    # N any multiple of 32 (a last block of 64 half empty), 1 to 7 actions,
    # at most 625 cells: the shapes the kernel took before its blocks grew
    # to 64 envs; a hidden width that is a multiple of 32 up to 512 and an
    # odd view up to 31, at which the JAX package's kernel traces too.
    assert (ar.shape_refusal(env, n, hidden) is None) == accepted
    monkeypatch.setattr(ar, "fused_eligible", lambda env, device: True)
    assert ar.supports_fused_actor(env, "cuda", n, hidden) == accepted
