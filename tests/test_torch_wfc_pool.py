"""The shared-pool reset supply of the plain path
(``minigrid_tpu_torch/parallel/vector.py``: ``make_pool_stepper``,
``batch_reset_pool``, the pool branch of ``rollout_capacity`` and
``rollout_random``) against the JAX package's: one pool drawn by the port,
carried to JAX by ``utils/bridge.py``, stepped by both steppers on the same
actions, every state field, reward and ``consumed`` exact; on WFC (the
slice's family, at size 9) and on DoorKey."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minigrid_tpu as mg
import minigrid_tpu_torch as mgt
from minigrid_tpu.parallel.vector import make_pool_stepper as j_make_pool_stepper
from minigrid_tpu_torch.core.sampling import randint
from minigrid_tpu_torch.parallel import reset_budget as trb
from minigrid_tpu_torch.parallel.vector import (
    batch_reset_pool,
    make_pool_stepper,
    plain_pool_size,
    rollout_capacity,
    rollout_random,
)
from torch_port_util import assert_states_equal, one_torch_thread, to_jax  # noqa: F401  (fixture)

N, STEPS, POOL = 64, 32, 160


@pytest.mark.parametrize(
    "env_id,kwargs", [("MiniGrid-WFC-MazeSimple-v0", {"size": 9}), ("MiniGrid-DoorKey-5x5-v0", {})]
)
def test_pool_stepper_equals_jax(one_torch_thread, env_id, kwargs):
    tenv, jenv = mgt.make(env_id, **kwargs), mg.make(env_id, **kwargs)
    gen = torch.Generator().manual_seed(0)
    _, states = tenv.reset(N, gen, "cpu")
    # Episode ages within the window of the limit: every env truncates in it.
    states = states.replace(step_count=randint(gen, N, states.max_steps - STEPS, states.max_steps))
    pool = batch_reset_pool(tenv, gen, POOL, "cpu")
    assert pool.grid.shape == (POOL, tenv.width, tenv.height)
    jstep = jax.jit(j_make_pool_stepper(jenv, to_jax(pool), N))
    step = make_pool_stepper(tenv, pool, N)
    actions = np.random.default_rng(1).integers(0, 7, (STEPS, N), dtype=np.int32)
    jst, jconsumed = to_jax(states), jnp.zeros((), jnp.int32)
    consumed = torch.zeros((), dtype=torch.int32)
    for t in range(STEPS):
        jst, jr, jterm, jtrunc, jconsumed = jstep(jst, jnp.asarray(actions[t]), jconsumed)
        states, r, term, trunc, consumed = step(states, torch.from_numpy(actions[t].copy()), consumed)
        assert_states_equal(states, jst, f"{env_id} step {t}")
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-6, atol=0)
        np.testing.assert_array_equal(term.numpy(), np.asarray(jterm))
        np.testing.assert_array_equal(trunc.numpy(), np.asarray(jtrunc))
        assert int(consumed) == int(jconsumed), t
    assert N <= int(consumed) <= POOL  # every env took a fresh level


def test_pool_rows_go_to_the_ended_envs_in_order():
    # Every env truncates on the same step: env i takes pool row i.
    env = mgt.make("MiniGrid-LavaCrossingS9N2-v0", max_steps=2)
    gen = torch.Generator().manual_seed(9)
    _, states = env.reset(4, gen, "cpu")
    pool = batch_reset_pool(env, gen, 16, "cpu")
    step = make_pool_stepper(env, pool, 4)
    consumed = torch.zeros((), dtype=torch.int32)
    for _ in range(2):
        states, _, _, trunc, consumed = step(states, torch.zeros(4, dtype=torch.int32), consumed)
    assert bool(trunc.all()) and int(consumed) == 4
    assert torch.equal(states.grid, pool.grid[:4]) and torch.equal(states.agent_pos, pool.agent_pos[:4])


def test_plain_rollout_draws_the_pool_then_the_actions(one_torch_thread):
    # The plain path of an expensive_reset family: the pool from the
    # generator first, then each step's actions; max_used is the pool rows
    # consumed, one a finished episode.
    env = mgt.make("MiniGrid-WFC-ObstaclesBlackdots-v0", size=7, max_steps=20)
    gen = torch.Generator().manual_seed(4)
    _, states = env.reset(N, gen, "cpu")
    snapshot = gen.get_state()
    final, total_r, done, used = rollout_random(env, states, gen, STEPS)
    capacity = rollout_capacity(env, STEPS, "cpu", num_envs=N)
    assert capacity == trb.pool_size(env, STEPS, N) and N <= int(used) == int(done) <= capacity
    gen.set_state(snapshot)
    pool = batch_reset_pool(env, gen, capacity, "cpu")
    step = make_pool_stepper(env, pool, N)
    st, consumed, reward = states, torch.zeros((), dtype=torch.int32), torch.zeros(())
    for _ in range(STEPS):
        actions = torch.randint(0, env.num_actions, (N,), generator=gen, dtype=torch.int32)
        st, r, _, _, consumed = step(st, actions, consumed)
        reward = reward + r.sum()
    assert torch.equal(st.grid, final.grid) and torch.equal(st.step_count, final.step_count)
    assert int(consumed) == int(used) and float(reward) == float(total_r)


def test_an_explicit_budget_sizes_the_pool_and_its_exhaustion_names_the_mean_table():
    # The JAX package's pool path ignores an explicit resets_per_chunk; here
    # it sizes the pool (num_envs * R levels), which rollout_capacity
    # reports and assert_chain_covered holds the chunk to.
    env = mgt.make("MiniGrid-DoorKey-5x5-v0", max_steps=4)
    assert plain_pool_size(env, 16, 8, 2) == rollout_capacity(env, 16, "cpu", num_envs=8, resets_per_chunk=2) == 16
    assert rollout_capacity(env, 16, "cuda", resets_per_chunk=2) == 2
    with pytest.raises(ValueError, match="num_envs"):
        rollout_capacity(env, 16, "cpu")
    gen = torch.Generator().manual_seed(2)
    _, states = env.reset(8, gen, "cpu")

    def chunk(carry):
        st, g = carry
        st, r, d, used = rollout_random(env, st, g, 16, 2)
        return (st, g), (r, d, used)

    with pytest.raises(AssertionError, match="MEASURED_MEAN_EPISODES_256"):
        trb.assert_chain_covered(chunk, (states, gen), 16, env, chunks=1, pool=True)


def test_a_short_max_steps_override_runs_the_pool_out_and_raises(one_torch_thread):
    # The pool is sized from the id's measured mean episode rate at its
    # registered limit; an override that ends episodes far more often runs
    # it out, and rollout_random raises rather than serve a level twice.
    env = mgt.make("MiniGrid-WFC-MazeSimple-v0", size=7, max_steps=2)
    gen = torch.Generator().manual_seed(6)
    _, states = env.reset(N, gen, "cpu")
    assert N * STEPS // 2 > rollout_capacity(env, STEPS, "cpu", num_envs=N)
    with pytest.raises(AssertionError, match="MEASURED_MEAN_EPISODES_256"):
        rollout_random(env, states, gen, STEPS)
    # An explicit budget of an episode a step covers any rate.
    _, _, done, used = rollout_random(env, states, gen, STEPS, STEPS)
    capacity = rollout_capacity(env, STEPS, "cpu", num_envs=N, resets_per_chunk=STEPS)
    assert N * STEPS // 2 <= int(used) == int(done) <= capacity
