"""The PyTorch port's actor-critic network, flax parameter bridge and packed
observation against the JAX package.

Both packages get the same weights (``utils/bridge.params_from_flax``) and
the same observations.  One-hot features and packed observations must match
exactly; network outputs agree to atol 2e-2, the bf16 rounding of the
activations.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minigrid_tpu as mg
import minigrid_tpu_torch as mgt
from minigrid_tpu.core.env import MiniGridEnv as JEnv
from minigrid_tpu.rl import model as jmodel
from minigrid_tpu_torch.core.env import MiniGridEnv
from minigrid_tpu_torch.rl import model as tmodel
from minigrid_tpu_torch.utils.bridge import params_from_flax, params_to_flax
from minigrid_tpu_torch.utils.synthetic import random_states
from torch_port_util import flax_params, jax_state, observations, port_model, to_port


def test_params_round_trip_bit_exact():
    packed, direction = observations(8)
    _, params = flax_params(packed, direction)
    state_dict = params_from_flax(params)
    assert sorted(state_dict) == sorted(
        f"Dense_{i}.{n}" for i in range(4) for n in ("kernel", "bias")
    )
    model = port_model(params)
    back = params_to_flax(model.state_dict())
    flat_a, tree_a = jax.tree.flatten(params)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    # The top-level "params" key is optional.
    inner = params_from_flax(params["params"])
    assert all(torch.equal(inner[k], state_dict[k]) for k in state_dict)


@pytest.mark.parametrize("packed_input", [True, False])
def test_actor_critic_matches_flax(packed_input):
    packed, direction = observations()
    jm, params = flax_params(packed, direction)
    model = port_model(params)
    if packed_input:
        x_j, x_t = packed, torch.from_numpy(packed)
    else:
        image = np.array(jax.vmap(mg.core.constants.unpack_grid)(jnp.asarray(packed).reshape(-1, 7, 7)))
        x_j, x_t = image, torch.from_numpy(image)
    want_logits, want_value = jm.apply(params, x_j, direction, packed=packed_input)
    with torch.no_grad():
        logits, value = model(x_t, torch.from_numpy(direction), packed=packed_input)
    assert logits.dtype == value.dtype == torch.float32
    assert logits.shape == (packed.shape[0], 7) and value.shape == (packed.shape[0],)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=0, atol=2e-2)
    np.testing.assert_allclose(value.numpy(), np.asarray(want_value), rtol=0, atol=2e-2)


def test_embed_obs_matches_jax_exactly():
    packed, direction = observations()
    want = np.asarray(jmodel.embed_obs_packed(jnp.asarray(packed), jnp.asarray(direction)), np.float32)
    got = tmodel.embed_obs_packed(torch.from_numpy(packed), torch.from_numpy(direction))
    assert got.dtype == torch.bfloat16 and got.shape == (packed.shape[0], tmodel.num_features(7))
    np.testing.assert_array_equal(got.float().numpy(), want)
    image = np.array(jax.vmap(mg.core.constants.unpack_grid)(jnp.asarray(packed).reshape(-1, 7, 7)))
    got_img = tmodel.embed_obs(torch.from_numpy(image), torch.from_numpy(direction))
    np.testing.assert_array_equal(got_img.float().numpy(), want)


def test_init_follows_lecun_normal():
    model = tmodel.ActorCritic(hidden=256, generator=torch.Generator().manual_seed(0))
    for name, layer in (("Dense_0", model.Dense_0), ("Dense_1", model.Dense_1),
                        ("Dense_2", model.Dense_2), ("Dense_3", model.Dense_3)):
        w = layer.kernel.detach()
        fan_in = w.shape[0]
        target = 1.0 / math.sqrt(fan_in)  # the variance lecun_normal keeps
        bound = 2 * target / 0.87962566103423978
        assert float(w.abs().max()) <= bound, name
        assert torch.count_nonzero(layer.bias) == 0, name
        if w.numel() >= 10_000:  # enough samples for a 3% bound on the std
            assert abs(float(w.std()) / target - 1) < 0.03, name
            assert abs(float(w.mean())) < 0.03 * target, name


@pytest.mark.parametrize("case", ["empty8x8", "synthetic"])
def test_observation_packed_matches_jax(case):
    if case == "empty8x8":
        jenv = mg.make("MiniGrid-Empty-8x8-v0")
        _, jstates = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(2), 64))
        env = mgt.make("MiniGrid-Empty-8x8-v0")
    else:
        jenv = JEnv(9, 7, max_steps=100)
        jstates = jax_state(random_states(np.random.default_rng(4), (256,), 9, 7))
        env = MiniGridEnv(9, 7, max_steps=100)
    want = jax.vmap(lambda s: jenv.observation_packed(s).reshape(-1))(jstates)
    got = env.observation_packed(to_port(jstates))
    assert got.dtype == torch.int32 and got.shape == (want.shape[0], 49)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
