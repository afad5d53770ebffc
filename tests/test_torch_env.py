"""The PyTorch port's batched env API, registry and reset budget against the
JAX package: Empty reset and stepping, ``step_cached`` with an R=2 cache,
the reset-budget tables."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minigrid_tpu as mg
import minigrid_tpu_torch as mgt
from minigrid_tpu.core.env import MiniGridEnv as JEnv
from minigrid_tpu.core.state import EnvState as JState
from minigrid_tpu.parallel import reset_budget as jrb
from minigrid_tpu_torch.core.env import MiniGridEnv
from minigrid_tpu_torch.parallel import reset_budget as trb
from minigrid_tpu_torch.utils.bridge import state_from_numpy
from minigrid_tpu_torch.utils.synthetic import random_states
from torch_port_util import assert_states_equal

EMPTY_IDS = [
    "MiniGrid-Empty-5x5-v0",
    "MiniGrid-Empty-6x6-v0",
    "MiniGrid-Empty-8x8-v0",
    "MiniGrid-Empty-16x16-v0",
]


def test_registered_ids_are_the_fixed_start_empty_subset():
    jax_ids = set(mg.registered_ids())
    fixed_empty = {i for i in jax_ids if i.startswith("MiniGrid-Empty-") and "Random" not in i}
    assert set(mgt.registered_ids()) == fixed_empty == set(EMPTY_IDS)


@pytest.mark.parametrize("env_id", ["MiniGrid-DoorKey-5x5-v0", "MiniGrid-Empty-Random-5x5-v0"])
def test_unported_ids_raise(env_id):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mgt.make(env_id)


@pytest.mark.parametrize("env_id", EMPTY_IDS)
def test_empty_reset_matches_jax(env_id):
    jenv, tenv = mg.make(env_id), mgt.make(env_id)
    assert (tenv.deterministic_generation, tenv.fused_no_objects, tenv.fused_static_mission) == (
        jenv.deterministic_generation, jenv.fused_no_objects, jenv.fused_static_mission,
    )
    jobs, jst = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(0), 16))
    obs, st = tenv.reset(16, torch.Generator().manual_seed(0))
    assert_states_equal(st, jst, env_id)
    np.testing.assert_array_equal(obs["image"].numpy(), np.asarray(jobs["image"]))
    np.testing.assert_array_equal(obs["mission"].numpy(), np.asarray(jobs["mission"]))
    assert tenv.mission_text(st.mission[0]) == "get to the green goal square"
    jcache = jenv.batch_reset_cache(jax.random.PRNGKey(1), 4, 2)
    assert_states_equal(tenv.batch_reset_cache(4, 2), jcache, f"{env_id} cache")
    assert_states_equal(tenv.reset_cache(3), jenv.reset_cache(jax.random.PRNGKey(2), 3), env_id)


@pytest.mark.parametrize("env_id,max_steps", [("MiniGrid-Empty-5x5-v0", 9), ("MiniGrid-Empty-8x8-v0", None)])
def test_empty_step_loop_matches_jax(env_id, max_steps):
    kw = {} if max_steps is None else {"max_steps": max_steps}
    jenv, tenv = mg.make(env_id, **kw), mgt.make(env_id, **kw)
    n, steps = 256, 24
    actions = np.random.default_rng(1).integers(0, 7, (steps, n), dtype=np.int32)
    _, jst = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(2), n))

    def body(st, a):
        obs, st, r, term, trunc = jax.vmap(jenv.step)(st, a)
        return st, (obs["image"], r, term, trunc)

    jfinal, (jimg, jrew, jterm, jtrunc) = jax.jit(lambda s, a: jax.lax.scan(body, s, a))(
        jst, jnp.asarray(actions)
    )
    _, st = tenv.reset(n)
    rewards = []
    for t in range(steps):
        obs, st, r, term, trunc = tenv.step(st, torch.from_numpy(actions[t]))
        np.testing.assert_array_equal(obs["image"].numpy(), np.asarray(jimg[t]), err_msg=f"obs {t}")
        np.testing.assert_array_equal(term.numpy(), np.asarray(jterm[t]), err_msg=f"term {t}")
        np.testing.assert_array_equal(trunc.numpy(), np.asarray(jtrunc[t]), err_msg=f"trunc {t}")
        rewards.append(r.numpy())
    assert_states_equal(st, jfinal, env_id)
    # One float32 ulp apart at most: XLA on the CPU fuses 1 - 0.9 * q into an FMA.
    np.testing.assert_allclose(np.stack(rewards), np.asarray(jrew), rtol=1e-6, atol=0)
    if max_steps is not None:
        assert np.asarray(jtrunc).any()


def test_step_cached_r2_matches_jax():
    # Object-rich states and an R=2 cache of other levels, so that the slot
    # rule min(used, R-1) and every reset path are exercised.
    rng = np.random.default_rng(4)
    n, r, steps, w, h = 256, 2, 16, 9, 7
    s = random_states(rng, (n,), w, h)
    c = random_states(rng, (n, r), w, h, fresh=True)
    actions = rng.integers(0, 7, (steps, n), dtype=np.int32)

    def jstate(arrays):
        lead = arrays["step_count"].shape
        keys = jnp.zeros(lead + (2,), jnp.uint32)
        return JState(**{k: jnp.asarray(v) for k, v in arrays.items()}, rng=keys)

    jenv = JEnv(w, h, max_steps=100, see_through_walls=False)
    tenv = MiniGridEnv(w, h, max_steps=100, see_through_walls=False)
    jst, jcache = jstate(s), jstate(c)
    st, cache = state_from_numpy(s), state_from_numpy(c)
    jused = jnp.zeros(n, jnp.int32)
    used = torch.zeros(n, dtype=torch.int32)
    jstep = jax.jit(jax.vmap(jenv.step_cached))
    for t in range(steps):
        jobs, jst, jr, _, _, jused = jstep(jst, jnp.asarray(actions[t]), jcache, jused)
        obs, st, rew, _, _, used = tenv.step_cached(st, torch.from_numpy(actions[t]), cache, used)
        np.testing.assert_array_equal(obs["image"].numpy(), np.asarray(jobs["image"]), err_msg=f"{t}")
        np.testing.assert_array_equal(used.numpy(), np.asarray(jused), err_msg=f"used {t}")
        np.testing.assert_allclose(rew.numpy(), np.asarray(jr), rtol=1e-6, atol=0)
        assert_states_equal(st, jst, f"step {t}")
    assert int(used.max()) > r  # past the last slot: replays exercised


def test_reset_budget_tables_match_jax():
    assert trb.MEASURED_MAX_EPISODES_256 == jrb.MEASURED_MAX_EPISODES_256
    assert trb.MEASURED_MEAN_EPISODES_256 == jrb.MEASURED_MEAN_EPISODES_256
    assert trb._FALLBACK_EPISODES_256 == jrb._FALLBACK_EPISODES_256


@pytest.mark.parametrize("num_steps", [1, 64, 256, 1000])
def test_resets_for_and_pool_size_match_jax(num_steps):
    class Dummy:  # a non-deterministic family, by id only
        deterministic_generation = False

    for env_id in list(jrb.MEASURED_MAX_EPISODES_256) + ["MiniGrid-Unmeasured-v0"]:
        assert trb.resets_for(Dummy(), num_steps, env_id) == jrb.resets_for(Dummy(), num_steps, env_id)
        assert trb.pool_size(Dummy(), num_steps, 4096, env_id) == jrb.pool_size(
            Dummy(), num_steps, 4096, env_id
        )
    for env_id in EMPTY_IDS:
        assert trb.resets_for(mgt.make(env_id), num_steps) == jrb.resets_for(mg.make(env_id), num_steps) == 1
    for m in (1, 2, 5, 37):
        assert trb.covering_resets(m, num_steps) == jrb.covering_resets(m, num_steps)


def test_assert_chain_covered_catches_an_exhausted_cache():
    # The real fused step (its plain version, on the CPU) on Empty-5x5 with
    # max_steps=3: every env ends an episode every 3 steps, so a 16-step
    # chunk consumes 5 slots.
    from minigrid_tpu_torch.ops.fused_rollout import fused_rollout

    env = mgt.make("MiniGrid-Empty-5x5-v0", max_steps=3)
    env.deterministic_generation = False  # hold it to the check like any family
    gen = torch.Generator().manual_seed(0)
    _, states = env.reset(64, gen)

    def chunk(st):
        st, r, d, chk, max_used = fused_rollout(env, st, gen, 16, 1, compute_obs=False)
        return st, (r, d, max_used)

    assert trb.assert_chain_covered(chunk, states, 5, env, chunks=2) == 5
    with pytest.raises(AssertionError, match="reset cache exhausted"):
        trb.assert_chain_covered(chunk, states, 4, env, chunks=2)
    assert trb.assert_chain_covered(chunk, states, 0, mgt.make("MiniGrid-Empty-5x5-v0")) == 0
