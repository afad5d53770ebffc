"""The port's fused-ext families against the JAX package: the counter-reset
helpers, each family's plain ``reset_block`` against the JAX ext's
``reset_state`` bit for bit (``extra`` included), Dynamic-Obstacles' step
hooks against JAX's ``step_env``, the level distribution of the port's
``env.reset`` against JAX's ``_generate``.  The JAX package's
``uniform_index`` fault, which the port does not copy, is
``test_torch_fused_ext_fault.py``'s: its 16x16 compile is a file of its
own, which the suite's workers can take alongside the others."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minigrid_tpu as mg
import minigrid_tpu_torch as mgt
from minigrid_tpu.ops import fused_ext as jfx
from minigrid_tpu_torch.ops import fused_ext as tfx
from test_counter_reset import _assert_close_freq
from torch_port_util import assert_states_equal, to_port

# Every registered counter-reset id whose draws stay within 128 candidates,
# where the JAX package's uniform_index does not wrap.
COUNTER_IDS = [
    "MiniGrid-Empty-Random-5x5-v0",
    "MiniGrid-Empty-Random-6x6-v0",
    "MiniGrid-LavaCrossingS9N1-v0",
    "MiniGrid-LavaCrossingS9N2-v0",
    "MiniGrid-LavaCrossingS9N3-v0",
    "MiniGrid-LavaCrossingS11N5-v0",
    "MiniGrid-SimpleCrossingS9N1-v0",
    "MiniGrid-SimpleCrossingS9N2-v0",
    "MiniGrid-SimpleCrossingS9N3-v0",
    "MiniGrid-SimpleCrossingS11N5-v0",
    "MiniGrid-Dynamic-Obstacles-5x5-v0",
    "MiniGrid-Dynamic-Obstacles-Random-5x5-v0",
    "MiniGrid-Dynamic-Obstacles-6x6-v0",
    "MiniGrid-Dynamic-Obstacles-Random-6x6-v0",
    "MiniGrid-Dynamic-Obstacles-8x8-v0",
]


def _seeds(n, seed):
    rng = np.random.default_rng(seed)
    seeds = rng.integers(-(2**31), 2**31, (n, 2)).astype(np.int32)
    return seeds, (np.arange(n) % 7).astype(np.int32)


def _jax_reset_states(jenv, seeds, eps):
    ext = jenv.fused_ext
    fn = jax.jit(jax.vmap(lambda s, e: ext.reset_state(jenv, s[0], s[1], e)))
    return fn(jnp.asarray(seeds), jnp.asarray(eps))


def test_counter_stream_helpers_match_jax():
    seeds, eps = _seeds(512, 1)
    e0, e1 = tfx.episode_seed(torch.from_numpy(seeds), torch.from_numpy(eps))
    j0, j1 = jax.vmap(jfx.episode_seed)(jnp.asarray(seeds[:, 0]), jnp.asarray(seeds[:, 1]), jnp.asarray(eps))
    np.testing.assert_array_equal(e0.numpy(), np.asarray(j0).view(np.uint32))
    np.testing.assert_array_equal(e1.numpy(), np.asarray(j1).view(np.uint32))
    for j in range(3):
        got = tfx.place_draw(e0, e1, j)
        want = jax.vmap(lambda a, b, j=j: jfx.place_draw(a, b, j))(j0, j1)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))

    rng = np.random.default_rng(2)
    m = rng.random((256, 49)) < 0.3
    target = rng.integers(-1, 20, 256).astype(np.int32)
    want = jfx.nth_true_index(jnp.asarray(m.T), jnp.asarray(target), jnp.full(256, 5, jnp.int32))
    got = tfx.nth_true_index(torch.from_numpy(m), torch.from_numpy(target), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    cells = [(7, 7, 8 | (1 << 8)), (3, 2, 9)]
    want = jfx.walled_plane(9, 9, (), cells)
    np.testing.assert_array_equal(tfx.walled_plane(2, 9, 9, "cpu", cells).numpy(), np.stack([want] * 2))


@pytest.mark.parametrize("env_id", COUNTER_IDS)
def test_reset_block_matches_jax(env_id):
    jenv, tenv = mg.make(env_id), mgt.make(env_id)
    jext, text = jenv.fused_ext, tenv.fused_ext
    assert (text.covers_reset, text.covers_pre_step, text.n_scalars, text.n_planes) == (
        jext.covers_reset, jext.covers_pre_step, jext.n_scalars, jext.n_planes
    )
    seeds, eps = _seeds(256, 3)
    jst = _jax_reset_states(jenv, seeds, eps)
    st = text.reset_block(tenv, torch.from_numpy(seeds), torch.from_numpy(eps))
    assert_states_equal(st, jst, env_id)


@pytest.mark.parametrize("env_id", ["MiniGrid-Dynamic-Obstacles-8x8-v0", "MiniGrid-Dynamic-Obstacles-Random-6x6-v0"])
def test_dynamic_obstacles_step_env_matches_jax(env_id):
    # The walk, the action remap and the collision penalty, step by step on
    # bridged states, without auto-reset.
    jenv, tenv = mg.make(env_id), mgt.make(env_id)
    n, steps = 256, 24
    _, jst = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(5), n))
    st = to_port(jst)
    actions = np.random.default_rng(6).integers(0, 7, (steps, n), dtype=np.int32)
    jstep = jax.jit(jax.vmap(jenv.step_env))
    collisions = 0
    for t in range(steps):
        jst, jr = jstep(jst, jnp.asarray(actions[t]))
        st, r = tenv.step_env(st, torch.from_numpy(actions[t]))
        assert_states_equal(st, jst, f"{env_id} step {t}")
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-6, atol=0)
        collisions += int((r == -1).sum())
    assert collisions > 0


def _bins(state, width, height):
    """Counts of (cell, object type) over the grids and of the agent's
    (cell, direction)."""
    n = state.grid.shape[0]
    types = (np.asarray(state.grid) & 0xFF).reshape(n, -1)
    cell_type = np.bincount((np.arange(width * height) * 16 + types).reshape(-1), minlength=width * height * 16)
    agent = np.asarray(state.agent_x) * height + np.asarray(state.agent_y)
    agent = np.bincount(agent * 4 + np.asarray(state.agent_dir), minlength=width * height * 4)
    return cell_type.astype(float), agent.astype(float)


@pytest.mark.parametrize(
    "env_id", ["MiniGrid-Empty-Random-5x5-v0", "MiniGrid-LavaCrossingS9N2-v0", "MiniGrid-Dynamic-Obstacles-8x8-v0"]
)
def test_reset_distribution_matches_jax_generate(env_id):
    # The port's generator is the counter stream at ordinal 0 on seeds from
    # the torch generator; JAX's _generate draws through jax.random.
    jenv, tenv = mg.make(env_id), mgt.make(env_id)
    n = 4096
    _, st = tenv.reset(n, torch.Generator().manual_seed(3))
    jst = jax.jit(jax.vmap(jenv._generate))(jax.random.split(jax.random.PRNGKey(9), n))
    for got, want in zip(_bins(st, tenv.width, tenv.height), _bins(jst, jenv.width, jenv.height)):
        _assert_close_freq(got, want, n)
