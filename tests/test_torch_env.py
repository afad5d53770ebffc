"""The PyTorch port's batched env API, registry and reset budget against the
JAX package: Empty reset and stepping, ``step_cached`` with an R=2 cache,
the reset-budget tables."""

from __future__ import annotations

import dataclasses

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
from minigrid_tpu_torch.core.state import resolve_device
from minigrid_tpu_torch.parallel import reset_budget as trb
from minigrid_tpu_torch.parallel.vector import VectorEnv
from minigrid_tpu_torch.rl import model as tmodel
from minigrid_tpu_torch.tools import measure_reset_budget
from minigrid_tpu_torch.utils.bridge import state_from_numpy
from minigrid_tpu_torch.utils.synthetic import random_states
from torch_port_util import assert_states_equal

EMPTY_IDS = [
    "MiniGrid-Empty-5x5-v0",
    "MiniGrid-Empty-6x6-v0",
    "MiniGrid-Empty-8x8-v0",
    "MiniGrid-Empty-16x16-v0",
]


# Every family of the JAX package.
PORTED_FAMILIES = ("MiniGrid-", "BabyAI-")
SHARED_ATTRS = (
    "width", "height", "max_steps", "see_through_walls", "agent_view_size", "deterministic_generation",
    "fused_no_objects", "fused_static_mission", "agent_start_pos", "agent_start_dir", "n_obstacles",
    "num_crossings", "obstacle_type", "expensive_reset", "num_objs", "_agent_default_pos", "_goal_default_pos",
    "num_dists", "doors_open", "fixed_max_steps", "max_gen_attempts", "unblocking",
    "obj_kind", "blocked", "key_in_box", "agent_room", "num_quarters", "v1", "random_length", "strip2_row",
    "goal_pos", "size", "l_wall", "r_wall", "room_size_wh", "min_rooms", "max_rooms", "max_room_size",
    "debug", "select_by", "first_color", "second_color", "strict", "num_doors", "objs_per_room",
    "start_carrying", "distractors", "locked_room_prob", "locations", "implicit_unlock", "action_kinds",
    "instr_kinds", "ensure_connected", "max_attempts",
)
# The BabyAI classes that take the JAX package's pool factor; the others set
# theirs from their validity measured in the port (ROADMAP.md queue 3).
JAX_POOL_FACTOR_MODULE = "minigrid_tpu_torch.envs.babyai.goto"


def test_registered_ids_are_the_fixed_start_empty_subset():
    # Every id of the JAX package, with its kwargs and kernel flags.
    ported = {i for i in mg.registered_ids() if i.startswith(PORTED_FAMILIES)}
    assert set(mgt.registered_ids()) == ported and len(ported) == 177
    assert set(EMPTY_IDS) < ported
    for env_id in sorted(ported):
        jenv, tenv = mg.make(env_id), mgt.make(env_id)
        for attr in SHARED_ATTRS:
            assert getattr(tenv, attr, None) == getattr(jenv, attr, None), (env_id, attr)
        # WFC's configuration: the same fields, each class its package's own.
        jconfig, tconfig = getattr(jenv, "config", None), getattr(tenv, "config", None)
        assert (jconfig is None) == (tconfig is None), env_id
        if jconfig is not None:
            assert dataclasses.asdict(tconfig) == dataclasses.asdict(jconfig), env_id
        assert (tenv.fused_ext is None) == (getattr(jenv, "fused_ext", None) is None), env_id
        if type(tenv).__module__ == JAX_POOL_FACTOR_MODULE or not hasattr(jenv, "pool_factor"):
            assert getattr(tenv, "pool_factor", None) == getattr(jenv, "pool_factor", None), env_id
        else:
            assert 1.0 <= tenv.pool_factor <= 4.0, env_id


@pytest.mark.parametrize("env_id", ["MiniGrid-WFC-NoSuchPreset-v0", "MiniGrid-Empty-7x7-v0"])
def test_unported_ids_raise(env_id):
    # An unknown id raises KeyError in both packages.
    for make in (mg.make, mgt.make):
        with pytest.raises(KeyError, match="unknown env id"):
            make(env_id)


def test_entry_points_default_to_cuda():
    # With neither a device nor a generator, new tensors go on CUDA: on a
    # machine without one that raises, and nothing lands on the CPU quietly.
    env = mgt.make("MiniGrid-Empty-5x5-v0")
    assert VectorEnv(env, 4).device.type == "cuda"
    assert VectorEnv(env, 4, "cpu").device.type == "cpu"
    assert resolve_device(torch.Generator(), None).type == "cpu"
    assert resolve_device(None, "cpu").type == "cpu"
    _, st = env.reset(4, torch.Generator().manual_seed(0))
    assert st.grid.device.type == "cpu"
    assert tmodel.ActorCritic(16, generator=torch.Generator()).Dense_0.kernel.device.type == "cpu"


@pytest.mark.parametrize("env_id", ["MiniGrid-Empty-8x8-v0", "MiniGrid-Dynamic-Obstacles-8x8-v0"])
def test_reset_without_device_or_generator_goes_to_cuda(env_id):
    env = mgt.make(env_id)
    calls = (lambda: env.reset(4)[1].grid, lambda: env.batch_reset_cache(4, 2).grid,
             lambda: tmodel.ActorCritic(16).Dense_0.kernel)
    for call in calls:
        if torch.cuda.is_available():
            assert call().device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                call()


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
    assert_states_equal(tenv.batch_reset_cache(4, 2, device="cpu"), jcache, f"{env_id} cache")
    assert_states_equal(tenv.reset_cache(3, device="cpu"), jenv.reset_cache(jax.random.PRNGKey(2), 3), env_id)


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
    _, st = tenv.reset(n, device="cpu")
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


MEASURED_MAX_CORRECTIONS: dict[str, int] = {"MiniGrid-FourRooms-v0": 6, "BabyAI-GoToLocal-v0": 12}
MEASURED_MEAN_CORRECTIONS: dict[str, float] = {}
# JAX rows the port's own measurement on the H100 replaced
# (minigrid_tpu_torch/tools/measure_reset_budget.py --chunks 32; ROADMAP.md
# queue 3): the per-env maximum and mean of each.  Every other JAX row must
# be in the port unchanged.
MEASURED_CORRECTIONS = {"max": MEASURED_MAX_CORRECTIONS, "mean": MEASURED_MEAN_CORRECTIONS}


@pytest.mark.parametrize(
    "port, jax_table, kind",
    [
        (trb.MEASURED_MAX_EPISODES_256, jrb.MEASURED_MAX_EPISODES_256, "max"),
        (trb.MEASURED_MEAN_EPISODES_256, jrb.MEASURED_MEAN_EPISODES_256, "mean"),
    ],
)
def test_reset_budget_tables_match_jax(port, jax_table, kind):
    # The port's table holds every JAX row, equal unless the port measured
    # it again, and its own measured rows besides (the GoTo and Fetch ids,
    # which JAX's table lacks); the fallback is JAX's.
    corrected = MEASURED_CORRECTIONS[kind]
    assert set(jax_table) <= set(port)
    for env_id, value in jax_table.items():
        if env_id in corrected:
            assert port[env_id] == corrected[env_id] != value, env_id
        else:
            assert port[env_id] == value, env_id
    assert trb._FALLBACK_EPISODES_256 == jrb._FALLBACK_EPISODES_256


def test_every_cached_id_the_kernels_run_has_a_measured_row():
    for env_id, _ in measure_reset_budget.CONFIGS:
        for table in (trb.MEASURED_MAX_EPISODES_256, trb.MEASURED_MEAN_EPISODES_256):
            assert env_id in table, env_id


@pytest.mark.parametrize(
    "env_id, steps, want",
    [
        # A learner's chunk takes the 256-step R: the scaled rule would give
        # GoToLocal 9 at 128 steps from its row 12, Fetch-8x8-N3 9 from its
        # row 13 (it ended 9 in a 128-step chunk) and GoToDoor-8x8 19 at 32
        # steps.
        ("BabyAI-GoToLocal-v0", 128, 15),
        ("MiniGrid-Fetch-8x8-N3-v0", 128, 17),
        ("MiniGrid-GoToDoor-8x8-v0", 32, 142),
        ("BabyAI-GoToLocal-v0", 256, 15),
        ("BabyAI-GoToLocal-v0", 512, 30),  # longer chunks scale as in JAX
        ("MiniGrid-DoorKey-8x8-v0", 128, 4),
    ],
)
def test_learners_take_the_256_step_r(env_id, steps, want):
    env = mgt.make(env_id)
    assert trb.learner_resets(env, steps) == want == trb.resets_for(env, max(steps, 256))
    if env_id in jrb.MEASURED_MAX_EPISODES_256:
        # JAX's rule on the port's row (JAX's own where no correction).
        row = trb.MEASURED_MAX_EPISODES_256[env_id]
        assert row == MEASURED_MAX_CORRECTIONS.get(env_id, jrb.MEASURED_MAX_EPISODES_256[env_id])
        assert want == jrb.covering_resets(row, max(steps, 256))
        assert trb.resets_for(env, steps) == jrb.covering_resets(row, steps)


@pytest.mark.parametrize("plain", [False, True])
def test_measure_reset_budget_counts_fresh_levels(plain):
    # 256 envs x 2 chunks of 32 steps of GoToDoor-5x5 (an episode ends about
    # every 3.5 steps): through the kernel's plain version with a 2-slot
    # cache, which no chunk can fit, so each chunk runs again at a larger R
    # until no env reached its last slot; or per-step regeneration.
    out = measure_reset_budget.measure(
        "MiniGrid-GoToDoor-5x5-v0", 256, 32, 2, plain, torch.device("cpu"), resets=None if plain else 2
    )
    assert out["how"] == ("plain" if plain else "kernel") and len(out["per_chunk_max"]) == 2
    assert 4 <= out["max"] <= 32 and 4 < out["mean_episodes_per_chunk"] < out["max"]
    if not plain:
        assert all(m < r for m, r in zip(out["per_chunk_max"], out["certified_at_R"]))


@pytest.mark.parametrize("num_steps", [1, 64, 256, 1000])
def test_resets_for_and_pool_size_match_jax(num_steps):
    class Dummy:  # a non-deterministic family, by id only
        deterministic_generation = False

    for env_id in list(jrb.MEASURED_MAX_EPISODES_256) + ["MiniGrid-Unmeasured-v0"]:
        if env_id in MEASURED_MAX_CORRECTIONS:  # JAX's rule on the port's measured row
            want = jrb.covering_resets(MEASURED_MAX_CORRECTIONS[env_id], num_steps)
        else:
            want = jrb.resets_for(Dummy(), num_steps, env_id)
        assert trb.resets_for(Dummy(), num_steps, env_id) == want
        if env_id in jrb.MEASURED_MEAN_EPISODES_256:
            assert trb.pool_size(Dummy(), num_steps, 4096, env_id) == jrb.pool_size(
                Dummy(), num_steps, 4096, env_id
            )
        else:  # the fallback pool takes the port's 256-step R for short chunks
            assert trb.pool_size(Dummy(), num_steps, 4096, env_id) == 4096 * jrb.resets_for(
                Dummy(), max(num_steps, 256), env_id
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
