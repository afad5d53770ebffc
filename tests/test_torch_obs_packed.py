"""The port's observation op (``ops/obs_packed.py``, K4's plain version on
the CPU) against the JAX package: its Pallas kernel in interpret mode on
rolled-out states, and its XLA observation (``core/obs.gen_obs_image``) on
object-rich random states at several view sizes.  States cross as numpy
(``utils/bridge.py``)."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import minigrid_tpu as mg
import minigrid_tpu_torch as mgt
from minigrid_tpu.core.obs import gen_obs_image as jax_gen_obs_image
from minigrid_tpu.core.obs import gen_obs_packed as jax_gen_obs_packed
from minigrid_tpu.ops.obs_pallas import fused_obs_packed as jax_fused_obs_packed
from minigrid_tpu.parallel.vector import rollout_random as jax_rollout_random
from minigrid_tpu_torch.core import obs as obs_lib
from minigrid_tpu_torch.core.constants import unpack_grid
from minigrid_tpu_torch.core.env import MiniGridEnv
from minigrid_tpu_torch.ops import obs_packed as op
from minigrid_tpu_torch.rl.impala import IMPALAConfig, make_impala
from minigrid_tpu_torch.rl.model import ActorCritic
from minigrid_tpu_torch.rl.ppo import PPOConfig, make_ppo
from minigrid_tpu_torch.rl.rollout import collect_trajectory
from minigrid_tpu_torch.utils.bridge import state_from_numpy
from minigrid_tpu_torch.utils.synthetic import random_states
from torch_port_util import jax_state, to_port


def _inputs(states):
    return states.grid, states.agent_x, states.agent_y, states.agent_dir, states.carrying


@pytest.mark.parametrize("env_id", ["MiniGrid-DoorKey-5x5-v0", "MiniGrid-Empty-8x8-v0"])
def test_obs_packed_matches_the_interpreted_pallas_kernel(env_id):
    # tests/test_pallas_ops.py's states: 64 resets rolled 25 random steps.
    env = mg.make(env_id)
    n = 64
    key = jax.random.PRNGKey(0)
    _, jstates = jax.jit(jax.vmap(env.reset))(jax.random.split(key, n))
    jstates, _, _, _ = jax_rollout_random(env, jstates, key, 25)
    want = jax_fused_obs_packed(*_inputs(jstates), 7, env.see_through_walls, block=n, interpret=True)
    states = to_port(jstates)
    got = op.fused_obs_packed(*_inputs(states), 7, env.see_through_walls)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if env_id.startswith("MiniGrid-DoorKey"):
        assert bool((got == 0).any()), "no occluded cell: the flood was not exercised"


@pytest.mark.parametrize("see_through", [False, True])
@pytest.mark.parametrize("view_size", [3, 5, 9])
def test_obs_packed_matches_jax_gen_obs_image(view_size, see_through):
    arrays = random_states(np.random.default_rng(view_size), (96,), 9, 7)
    jstates = jax_state(arrays)
    want = jax.jit(jax.vmap(lambda s: jax_gen_obs_image(s, view_size, see_through)))(jstates)
    got = unpack_grid(op.fused_obs_packed(*_inputs(state_from_numpy(arrays, "cpu")), view_size, see_through))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("view_size", [17, op.BUILT_VIEW_SIZES[-1]])
def test_the_plain_observation_matches_jax_past_15(view_size):
    # The kernel's widest views on a 22x22 grid (v = 31 overhangs it), JAX's
    # observation run op by op: most of the case is JAX compiling its ops
    # at the new view size, which jit would take longer to do.
    arrays = random_states(np.random.default_rng(view_size), (16,), 22, 22)
    want = jax.vmap(lambda s: jax_gen_obs_packed(s, view_size, False))(jax_state(arrays))
    got = op.fused_obs_packed(*_inputs(state_from_numpy(arrays, "cpu")), view_size, False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool((got == 0).any()) and bool((got != 0).any())


def test_core_obs_goes_through_the_op_and_plain_on_request():
    states = state_from_numpy(random_states(np.random.default_rng(1), (64,), 9, 7), "cpu")
    want = op.fused_obs_packed_reference(*_inputs(states), 7, False)
    env = MiniGridEnv(9, 7, max_steps=100)
    assert torch.equal(obs_lib.gen_obs_packed(states, 7, False), want)
    assert torch.equal(env.observation_packed(states), want.reshape(64, 49))
    assert torch.equal(env.observation_packed(states, plain=True), want.reshape(64, 49))
    assert set(env.observation(states, image=False)) == {"direction", "mission"}
    with obs_lib.plain_observations():
        assert torch.equal(env.observation(states)["image"], unpack_grid(want))
        with obs_lib.plain_observations():
            assert obs_lib._PLAIN.get()
        assert obs_lib._PLAIN.get()
    assert not obs_lib._PLAIN.get()


def _count_routes(monkeypatch) -> dict[str, int]:
    """Count the observations ``core/obs`` sends to the op (the kernel on a
    CUDA tensor) and to the plain version."""
    counts = {"op": 0, "plain": 0}
    for key, name in (("op", "fused_obs_packed"), ("plain", "fused_obs_packed_reference")):
        fn = getattr(obs_lib, name)

        def counted(*args, _fn=fn, _key=key):
            counts[_key] += 1
            return _fn(*args)

        monkeypatch.setattr(obs_lib, name, counted)
    return counts


@pytest.mark.parametrize("plain", [False, True])
def test_the_plain_collector_observes_through_the_op_unless_asked_for_plain(monkeypatch, plain):
    # collect_trajectory(fused_actor=False) is a public route: only the
    # learners' _plain timing reference asks it for the plain observation.
    env = mgt.make("MiniGrid-Empty-5x5-v0")
    gen = torch.Generator().manual_seed(0)
    _, states = env.reset(8, gen, device="cpu")
    model = ActorCritic(32, env.num_actions, env.agent_view_size, gen, "cpu")
    counts = _count_routes(monkeypatch)
    collect_trajectory(env, model, states, gen, 4, plain_obs=plain)
    assert counts == ({"op": 0, "plain": 4} if plain else {"op": 4, "plain": 0})


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("make, config_cls", [(make_ppo, PPOConfig), (make_impala, IMPALAConfig)])
def test_learners_observe_through_the_op_and_their_plain_reference_does_not(monkeypatch, make, config_cls, plain):
    # 4 collection steps and the bootstrap observation.
    env = mgt.make("MiniGrid-Empty-5x5-v0")
    init_fn, train_step = make(env, config_cls(rollout_steps=4, num_minibatches=1), hidden=32, _plain=plain)
    state = init_fn(torch.Generator().manual_seed(0), 8)
    counts = _count_routes(monkeypatch)
    train_step(state)
    assert counts == ({"op": 0, "plain": 5} if plain else {"op": 5, "plain": 0})


def test_the_op_raises_where_the_kernel_cannot_run():
    # The launch path refuses a CPU tensor and a size it was not built for;
    # a CPU tensor given to the op takes the plain version.
    states = state_from_numpy(random_states(np.random.default_rng(2), (8,), 9, 7), "cpu")
    with pytest.raises(ValueError, match="need CUDA"):
        op._launch(*_inputs(states), 7, False)
    assert op.fused_obs_packed(*_inputs(states), 17).shape == (8, 17, 17)
