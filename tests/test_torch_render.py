"""The port's renderer (``minigrid_tpu_torch/render``) against the JAX
package's: the tile atlas, and whole frames of bridged states, full with
the agent's view highlighted and from the agent's point of view.  Also pins
what the frames rely on: a packed observation cell is nonzero exactly where
the agent sees it."""

from __future__ import annotations

from functools import lru_cache

import jax
import numpy as np
import pytest
import torch

import minigrid_tpu as mg
from minigrid_tpu.parallel.vector import rollout_random as jax_rollout_random
from minigrid_tpu.render.atlas import tile_atlas as jax_tile_atlas
from minigrid_tpu.render.frame import get_frame as jax_get_frame
import minigrid_tpu_torch as mgt
from minigrid_tpu_torch.ops import obs_packed as op
from minigrid_tpu_torch.render.atlas import tile_atlas
from minigrid_tpu_torch.render.frame import get_frame
from minigrid_tpu_torch.utils.bridge import state_from_numpy
from minigrid_tpu_torch.utils.synthetic import random_states
from torch_port_util import jax_state, to_port


@pytest.mark.parametrize("tile_size", [8, 32])
def test_tile_atlas_matches_jax(tile_size):
    np.testing.assert_array_equal(tile_atlas(tile_size), jax_tile_atlas(tile_size))


@lru_cache(maxsize=None)
def _doorkey_states(n=24):
    env = mg.make("MiniGrid-DoorKey-6x6-v0")
    key = jax.random.PRNGKey(1)
    _, states = jax.jit(jax.vmap(env.reset))(jax.random.split(key, n))
    states, _, _, _ = jax_rollout_random(env, states, key, 20)
    return states


@pytest.mark.parametrize("agent_pov", [False, True])
@pytest.mark.parametrize("source", ["doorkey", "synthetic"])
def test_frames_match_jax(source, agent_pov):
    # Synthetic states carry objects and see through doors and walls of
    # every kind; DoorKey's are rolled out from real resets.
    if source == "doorkey":
        jstates = _doorkey_states()
        states = to_port(jstates)
    else:
        arrays = random_states(np.random.default_rng(4), (24,), 9, 7)
        jstates, states = jax_state(arrays), state_from_numpy(arrays, "cpu")
    want = jax.jit(
        jax.vmap(lambda s: jax_get_frame(s, 7, False, highlight=True, tile_size=8, agent_pov=agent_pov))
    )(jstates)
    got = get_frame(states, 7, False, highlight=True, tile_size=8, agent_pov=agent_pov)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_env_render_is_the_full_frame():
    env = mgt.make("MiniGrid-DoorKey-5x5-v0")
    _, states = env.reset(3, torch.Generator().manual_seed(0), "cpu")
    frame = env.render(states, tile_size=8)
    assert isinstance(frame, np.ndarray) and frame.shape == (3, 40, 40, 3) and frame.dtype == np.uint8
    np.testing.assert_array_equal(frame, get_frame(states, 7, False, tile_size=8).numpy())
    assert env.get_frame(states, tile_size=8, agent_pov=True).shape == (3, 56, 56, 3)


@pytest.mark.parametrize("see_through", [False, True])
@pytest.mark.parametrize("view_size", [3, 7, 11])
def test_a_packed_cell_is_nonzero_exactly_where_it_is_seen(view_size, see_through):
    # No state cell packs to 0 (an empty cell is 1) and the agent cell,
    # which holds the carried object or empty, is always seen; so the
    # frames may take visibility from the observation as packed != 0.
    arrays = random_states(np.random.default_rng(view_size), (256,), 9, 7)
    states = state_from_numpy(arrays, "cpu")
    args = (states.grid, states.agent_x, states.agent_y, states.agent_dir, states.carrying, view_size, see_through)
    cells, vis = op.view_and_vis_packed(*args)
    assert bool((states.grid != 0).all()) and bool((cells != 0).all())
    assert bool(vis[:, view_size // 2, view_size - 1].all())
    assert torch.equal(op.fused_obs_packed(*args) != 0, vis)
    assert see_through or not bool(vis.all())


@pytest.mark.parametrize("env_id", ["MiniGrid-DoorKey-8x8-v0", "MiniGrid-FourRooms-v0", "BabyAI-GoToLocal-v0"])
def test_generated_levels_have_no_cell_that_packs_to_zero(env_id):
    env = mgt.make(env_id)
    _, states = env.reset(32, torch.Generator().manual_seed(7), "cpu")
    assert bool((states.grid != 0).all())
