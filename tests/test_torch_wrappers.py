"""The port's wrappers (``minigrid_tpu_torch/wrappers``) against the original
Minigrid's recorded outputs (``tests/golden/wrappers_*.npz``,
``nodeath_lava.npz``) and against the JAX package's wrappers on the same
states, which cross as numpy (``utils/bridge.py``)."""

from __future__ import annotations

import os
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minigrid_tpu as mg
import minigrid_tpu.wrappers as jwr
import minigrid_tpu_torch as mgt
import minigrid_tpu_torch.wrappers as twr
from minigrid_tpu_torch.core import obs as obs_lib
from minigrid_tpu.parallel.vector import rollout_random as jax_rollout_random
from minigrid_tpu_torch.ops.fused_rollout import supports_fused
from minigrid_tpu_torch.parallel.vector import fused_eligible, rollout_random
from minigrid_tpu_torch.utils import golden
from torch_port_util import assert_states_equal, to_port

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
WRAPPER_IDS = ("MiniGrid-DoorKey-8x8-v0", "MiniGrid-LavaCrossingS9N2-v0")
CASES = ("fully", "onehot", "symbolic", "dict_mission", "flat", "view5", "rgb_full", "rgb_pov")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("env_id", WRAPPER_IDS)
def test_wrapper_outputs_match_the_recorded_ones(env_id, case):
    # tests/test_wrappers.py's 8 cases on the same 120 recorded states.
    path = os.path.join(GOLDEN_DIR, f"wrappers_{env_id}.npz")
    assert golden.replay_wrappers(path, "cpu", keys=(case,)) == 120


def test_nodeath_matches_the_recorded_transitions():
    assert golden.replay_nodeath(os.path.join(GOLDEN_DIR, "nodeath_lava.npz")) == 450


def test_wrapper_names_match_jax():
    assert twr.__all__ == jwr.__all__


@lru_cache(maxsize=None)
def _rolled(env_id, n=48, steps=12):
    """JAX states after ``steps`` random steps from ``n`` resets."""
    env = mg.make(env_id)
    key = jax.random.PRNGKey(0)
    _, states = jax.jit(jax.vmap(env.reset))(jax.random.split(key, n))
    states, _, _, _ = jax_rollout_random(env, states, key, steps)
    return states


@pytest.mark.parametrize("kind", ["slope", "angle"])
def test_direction_obs_matches_jax(kind):
    jstates = _rolled("MiniGrid-DoorKey-5x5-v0")
    jwrapped = jwr.DirectionObsWrapper(mg.make("MiniGrid-DoorKey-5x5-v0"), type=kind)
    want = jax.jit(jax.vmap(jwrapped.observation))(jstates)
    got = twr.DirectionObsWrapper(mgt.make("MiniGrid-DoorKey-5x5-v0"), type=kind).observation(to_port(jstates))
    np.testing.assert_array_equal(got["goal_direction"].numpy(), np.asarray(want["goal_direction"]))
    np.testing.assert_array_equal(got["image"].numpy(), np.asarray(want["image"]))


@pytest.mark.parametrize("wrapper", ["ActionBonus", "PositionBonus"])
def test_bonus_wrappers_match_jax(wrapper):
    # Fixed-start Empty with a short limit: episodes end and reset within
    # the run, and both packages' resets give the same level.
    n, steps = 16, 24
    jwrapped = getattr(jwr, wrapper)(mg.make("MiniGrid-Empty-5x5-v0", max_steps=7))
    twrapped = getattr(twr, wrapper)(mgt.make("MiniGrid-Empty-5x5-v0", max_steps=7))
    _, jstate = jax.jit(jax.vmap(jwrapped.reset))(jax.random.split(jax.random.PRNGKey(1), n))
    _, tstate = twrapped.reset(n, torch.Generator().manual_seed(1), "cpu")
    assert_states_equal(tstate.env, jstate.env, "reset")
    jstep = jax.jit(jax.vmap(jwrapped.step))
    actions = np.random.default_rng(2).integers(0, 7, (steps, n), dtype=np.int32)
    for t, a in enumerate(actions):
        jobs, jstate, jr, jterm, jtrunc = jstep(jstate, jnp.asarray(a))
        tobs, tstate, tr, tterm, ttrunc = twrapped.step(tstate, torch.from_numpy(a))
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6, atol=0, err_msg=f"reward {t}")
        np.testing.assert_array_equal(tstate.counts.numpy(), np.asarray(jstate.counts), err_msg=f"counts {t}")
        np.testing.assert_array_equal(tterm.numpy(), np.asarray(jterm))
        np.testing.assert_array_equal(ttrunc.numpy(), np.asarray(jtrunc))
        np.testing.assert_array_equal(tobs["image"].numpy(), np.asarray(jobs["image"]))
        assert_states_equal(tstate.env, jstate.env, f"step {t}")
    assert int(tstate.counts.sum()) == n * steps and int(tstate.counts.max()) > 1


@pytest.mark.parametrize("prob, random_action", [(1.0, None), (0.0, 2), (0.0, 5)])
def test_stochastic_action_matches_jax_where_it_is_determined(prob, random_action):
    # prob 1 keeps every action, prob 0 takes the fixed random_action: no
    # draw decides the outcome, so the two packages agree step for step.
    jstates = _rolled("MiniGrid-DoorKey-5x5-v0")
    actions = np.random.default_rng(3).integers(0, 7, 48, dtype=np.int32)
    jw = jwr.StochasticActionWrapper(mg.make("MiniGrid-DoorKey-5x5-v0"), prob=prob, random_action=random_action)
    tw = twr.StochasticActionWrapper(mgt.make("MiniGrid-DoorKey-5x5-v0"), prob=prob, random_action=random_action)
    jstepped, jr = jax.jit(jax.vmap(jw.step_env))(jstates, jnp.asarray(actions))
    tstepped, tr = tw.step_env(to_port(jstates), torch.from_numpy(actions), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6, atol=0)
    assert_states_equal(tstepped, jstepped)


def test_stochastic_action_draws_like_the_reference():
    # The fallback is uniform over [0, 6), never `done`, and the chosen
    # action is kept with probability prob.
    tw = twr.StochasticActionWrapper(mgt.make("MiniGrid-Empty-5x5-v0"), prob=0.7)
    n = 60000
    out = tw._perturb(torch.full((n,), 6), n, torch.device("cpu"), torch.Generator().manual_seed(4))
    kept = float((out == 6).float().mean())
    assert abs(kept - 0.7) < 0.01
    counts = torch.bincount(out[out != 6].long(), minlength=6)
    assert counts.shape == (6,) and float(counts.min()) > 0.9 * float(counts.float().mean())


def test_reseed_cycles_its_seeds_as_jax_does():
    seeds = [3, 5, 9]
    jw = jwr.ReseedWrapper(mg.make("MiniGrid-Empty-Random-5x5-v0"), seeds=seeds, seed_idx=1)
    tw = twr.ReseedWrapper(mgt.make("MiniGrid-Empty-Random-5x5-v0"), seeds=seeds, seed_idx=1)
    states = []
    for _ in range(2 * len(seeds)):
        jw.reset()
        states.append(tw.reset(64, device="cpu")[1])
        assert tw.seed_idx == jw.seed_idx
    for i in range(len(seeds)):
        a, b = states[i], states[i + len(seeds)]
        assert torch.equal(a.grid, b.grid) and torch.equal(a.agent_pos, b.agent_pos)
    assert not torch.equal(states[0].agent_pos, states[1].agent_pos)


def test_wrapped_envs_take_the_plain_path():
    # supports_fused refuses a wrapper (its observation is not the
    # default one) without tripping over the delegation, and
    # rollout_random then runs the plain path through the wrapper (the
    # shared pool of resets: LavaCrossing is an expensive_reset family).
    env = mgt.make("MiniGrid-LavaCrossingS9N1-v0")
    for wrapped in (twr.ImgObsWrapper(env), twr.NoDeath(env, ("lava",)), twr.ViewSizeWrapper(env, 5)):
        assert not supports_fused(wrapped)
        assert not fused_eligible(wrapped, "cuda")
    nodeath = twr.NoDeath(env, ("lava",))
    gen = torch.Generator().manual_seed(5)
    _, states = nodeath.reset(64, gen, "cpu")
    final, total_r, done, max_used = rollout_random(nodeath, states, gen, 32)
    assert final.grid.shape == (64, 9, 9) and int(max_used) == int(done) and np.isfinite(float(total_r))


def test_observation_wrappers_reset_and_step_batches():
    env = mgt.make("MiniGrid-DoorKey-5x5-v0")
    gen = torch.Generator().manual_seed(6)
    a = torch.full((4,), 2, dtype=torch.int32)
    for wrapped, shape in (
        (twr.ImgObsWrapper(env), (4, 7, 7, 3)),
        (twr.FlatObsWrapper(env), (4, 7 * 7 * 3 + 96 * 28)),
        (twr.ImgObsWrapper(twr.ViewSizeWrapper(env, 9)), (4, 9, 9, 3)),
        (twr.ImgObsWrapper(twr.RGBImgPartialObsWrapper(env, tile_size=4)), (4, 28, 28, 3)),
    ):
        obs, states = wrapped.reset(4, gen, "cpu")
        assert tuple(obs.shape) == shape
        obs, states, reward, term, trunc = wrapped.step(states, a, gen)
        assert tuple(obs.shape) == shape and reward.shape == (4,)
    assert twr.ImgObsWrapper(twr.NoDeath(env, ("lava",))).unwrapped is env


@pytest.mark.parametrize(
    "make, views",
    [
        (lambda e: twr.ImgObsWrapper(twr.ViewSizeWrapper(e, agent_view_size=5)), [5]),
        (lambda e: twr.ViewSizeWrapper(twr.OneHotPartialObsWrapper(e), agent_view_size=5), [5]),
        (twr.OneHotPartialObsWrapper, [7]),
        (twr.FullyObsWrapper, []),
        (lambda e: twr.DirectionObsWrapper(twr.SymbolicObsWrapper(e)), []),
        (lambda e: twr.DictObservationSpaceWrapper(twr.FullyObsWrapper(e)), []),
        (lambda e: twr.RGBImgObsWrapper(e, tile_size=8), [7]),
        (lambda e: twr.RGBImgPartialObsWrapper(e, tile_size=8), [7]),
    ],
)
def test_a_wrapper_that_replaces_the_image_computes_no_inner_view(monkeypatch, make, views):
    # Eager PyTorch keeps what XLA's jit drops: a replaced inner image would
    # be a second observation (kernel launch and unpacking) every step.
    asked = []
    op = obs_lib.fused_obs_packed
    monkeypatch.setattr(obs_lib, "fused_obs_packed", lambda *a: asked.append(a[5]) or op(*a))
    env = make(mgt.make("MiniGrid-DoorKey-5x5-v0"))
    gen = torch.Generator().manual_seed(0)
    _, state = env.reset(4, gen, device="cpu")
    asked.clear()  # a reset observes its inner env too, once a batch of episodes
    obs, *_ = env.step(state, torch.full((4,), 2, dtype=torch.int32), gen)
    assert asked == views
    if isinstance(obs, dict):
        assert next(iter(obs)) == "image"
