"""The PyTorch port's core step and observation: the recorded reference
transitions (``tests/golden``), and the JAX package's ``core_step`` and
``gen_obs_packed`` on the same random batched states."""

from __future__ import annotations

import functools
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minigrid_tpu as mg
from minigrid_tpu.core.obs import gen_obs_packed as j_gen_obs_packed
from minigrid_tpu.core.state import EnvState as JState
from minigrid_tpu.core.step import core_step as j_core_step
from minigrid_tpu_torch.core.constants import pack_carry, see_behind, unpack_grid
from minigrid_tpu_torch.core.obs import gen_obs_image, gen_obs_packed, process_vis
from minigrid_tpu_torch.core.state import new_state
from minigrid_tpu_torch.core.step import core_step
from minigrid_tpu_torch.utils.synthetic import random_states
from torch_port_util import assert_states_equal, to_port

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
STEP_FILES = sorted(glob.glob(os.path.join(GOLDEN_DIR, "steps_*.npz")))


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_ten_step_fixtures():
    assert len(STEP_FILES) == 10


@pytest.mark.parametrize("path", STEP_FILES, ids=os.path.basename)
def test_step_and_obs_golden(path):
    d = _load(path)
    t = {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
    state = new_state(
        t["grid_pre"], t["pos_pre"], t["dir_pre"], int(d["max_steps"]), contains=t["contains_pre"]
    )
    c = t["carry_pre"].int()
    state = state.replace(
        carrying=pack_carry(c[:, 0], c[:, 1], c[:, 2], c[:, 3]),
        step_count=t["step_count_pre"].int(),
    )
    state, reward = core_step(state, t["action"])
    obs = gen_obs_image(state, int(d["agent_view_size"]), bool(d["see_through_walls"]))

    np.testing.assert_array_equal(unpack_grid(state.grid).numpy(), d["grid_post"])
    contains = torch.stack([state.contains & 0xFF, (state.contains >> 8) & 0xFF], -1)
    np.testing.assert_array_equal(contains.numpy().astype(np.uint8), d["contains_post"])
    np.testing.assert_array_equal(state.agent_pos.numpy(), d["pos_post"])
    np.testing.assert_array_equal(state.agent_dir.numpy(), d["dir_post"])
    carry = torch.stack([(state.carrying >> s) & 0xFF for s in (0, 8, 16, 24)], -1)
    np.testing.assert_array_equal(carry.numpy().astype(np.uint8), d["carry_post"])
    # The reference computed the reward in float64; float32 here, as in
    # tests/test_golden_parity.py.
    np.testing.assert_allclose(reward.numpy(), d["reward"], rtol=1e-6)
    np.testing.assert_array_equal(state.terminated.numpy(), d["terminated"])
    np.testing.assert_array_equal(state.truncated.numpy(), d["truncated"])
    np.testing.assert_array_equal(obs.numpy(), d["obs_image"])


def test_process_vis_golden():
    d = _load(os.path.join(GOLDEN_DIR, "process_vis.npz"))
    grids = torch.from_numpy(d["grids"]).int()
    vis = process_vis(see_behind(grids[..., 0], grids[..., 2]))
    np.testing.assert_array_equal(vis.numpy(), d["masks"])


# -- Against the JAX package on random batched states ---------------------

NUM_ENVS = 256
NUM_STEPS = 12
CASES = ["MiniGrid-DoorKey-8x8-v0", "MiniGrid-FourRooms-v0", "synthetic-9x7"]


@functools.lru_cache(maxsize=None)
def _trajectory(case: str):
    """(pre-states, actions, view size, see-through) along a random JAX
    trajectory: fresh levels stepped by random actions, or object-rich
    synthetic states."""
    rng = np.random.default_rng(11)
    actions = rng.integers(0, 7, (NUM_STEPS, NUM_ENVS), dtype=np.int32)
    if case.startswith("synthetic"):
        arrays = random_states(rng, (NUM_STEPS * NUM_ENVS,), 9, 7)
        keys = np.zeros((NUM_STEPS * NUM_ENVS, 2), np.uint32)
        flat = JState(**{k: jnp.asarray(v) for k, v in arrays.items()}, rng=jnp.asarray(keys))
        pre = [jax.tree.map(lambda a, i=i: a[i * NUM_ENVS:(i + 1) * NUM_ENVS], flat) for i in range(NUM_STEPS)]
        return pre, actions, 7, False
    env = mg.make(case)
    _, st = jax.jit(jax.vmap(env.reset))(jax.random.split(jax.random.PRNGKey(3), NUM_ENVS))
    step = jax.jit(jax.vmap(env.step))
    pre = []
    for a in actions:
        pre.append(st)
        _, st, _, _, _ = step(st, jnp.asarray(a))
    return pre, actions, env.agent_view_size, env.see_through_walls


@pytest.mark.parametrize("case", CASES)
def test_core_step_matches_jax(case):
    pre, actions, _, _ = _trajectory(case)
    jstep = jax.jit(jax.vmap(j_core_step))
    for t, (st, a) in enumerate(zip(pre, actions)):
        jnext, jrew = jstep(st, jnp.asarray(a))
        nxt, rew = core_step(to_port(st), torch.from_numpy(a))
        assert_states_equal(nxt, jnext, f"{case} step {t}")
        # XLA on the CPU contracts 1 - 0.9 * q into one FMA; the port rounds
        # each float32 operation, so the two may differ by one ulp.
        np.testing.assert_allclose(
            rew.numpy(), np.asarray(jrew), rtol=1e-6, atol=0, err_msg=f"{case} step {t}"
        )


@pytest.mark.parametrize("case", CASES)
def test_gen_obs_packed_matches_jax(case):
    pre, _, view, see_through = _trajectory(case)
    jobs = jax.jit(jax.vmap(lambda s: j_gen_obs_packed(s, view, see_through)))
    for t, st in enumerate(pre):
        got = gen_obs_packed(to_port(st), view, see_through).numpy()
        np.testing.assert_array_equal(got, np.asarray(jobs(st)), err_msg=f"{case} step {t}")


def test_synthetic_states_hold_objects():
    arrays = random_states(np.random.default_rng(0), (512,), 9, 7)
    types = arrays["grid"] & 0xFF
    for obj in (4, 5, 6, 7, 8, 9):  # door, key, ball, box, goal, lava
        assert (types == obj).any(), obj
    assert (arrays["contains"] != 0).any() and (arrays["carrying"] != 0).any()


def test_grid_ops_match_jax():
    from minigrid_tpu.core import grid as jg
    from minigrid_tpu_torch.core import grid as tg

    rng = np.random.default_rng(2)
    n, w, h = 64, 9, 7
    arrays = random_states(rng, (n,), w, h)
    xs = rng.integers(0, w, n).astype(np.int32)
    ys = rng.integers(0, h, n).astype(np.int32)
    values = rng.integers(0, 1 << 18, n).astype(np.int32)
    jgrid = jnp.asarray(arrays["grid"])
    grid = torch.from_numpy(arrays["grid"])

    jwalls = jax.vmap(lambda g: jg.wall_rect(g, 1, 2, 5, 4))(jgrid)
    np.testing.assert_array_equal(tg.wall_rect(grid, 1, 2, 5, 4).numpy(), np.asarray(jwalls))
    jset = jax.vmap(jg.set_cell)(jgrid, jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(values))
    tset = tg.set_cell(grid, torch.from_numpy(xs), torch.from_numpy(ys), torch.from_numpy(values))
    np.testing.assert_array_equal(tset.numpy(), np.asarray(jset))
    jget = jax.vmap(jg.get_cell)(jgrid, jnp.asarray(xs), jnp.asarray(ys))
    tget = tg.get_cell(grid, torch.from_numpy(xs), torch.from_numpy(ys))
    np.testing.assert_array_equal(tget.numpy(), np.asarray(jget))
    pos = np.stack([xs, ys], -1)
    jfree = jax.vmap(jg.free_mask)(jgrid, jnp.asarray(pos))
    np.testing.assert_array_equal(tg.free_mask(grid, torch.from_numpy(pos)).numpy(), np.asarray(jfree))
    np.testing.assert_array_equal(
        tg.empty_grid(2, w, h).numpy(), np.asarray(jnp.stack([jg.empty_grid(w, h)] * 2))
    )
