"""The classic MiniGrid families of the zoo's last slice (Unlock,
UnlockPickup, BlockedUnlockPickup, KeyCorridor, ObstructedMaze, DistShift,
LavaGap, Memory, PutNear, RedBlueDoors, LockedRoom, Playground, MultiRoom)
against the JAX package.

* Each family's step hooks (``_map_action``, ``_post_step``, which runs the
  ext twin's plain ``post_step``) against JAX's ``step_env`` on random
  object-rich transitions, made so that the hooks' events happen: the
  family's door, target or cells put in front of the agent half the time,
  the matching key or object carried.  Every field, ``extra`` and the
  reward; the reward to rtol 1e-6 (XLA's FMA).
* DistShift's deterministic level exactly; the recorded DistShift1 and
  LavaGapS7 transitions through the families' ``step_env``.
* The kernels' ext buffers: copies of the live scalars (a one-scalar pack
  was handed to the actor kernel as the state's own tensor), and none for
  ObstructedMaze's scalar-free ext.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minigrid_tpu as mg
import minigrid_tpu_torch as mgt
from minigrid_tpu.core.state import EnvState as JState
from minigrid_tpu_torch.core.constants import (
    COLOR_BLUE,
    COLOR_RED,
    OBJ_BALL,
    OBJ_DOOR,
    OBJ_EMPTY,
    OBJ_KEY,
    NUM_COLORS,
)
from minigrid_tpu_torch.ops import fused_rollout as fr
from minigrid_tpu_torch.utils import golden
from minigrid_tpu_torch.utils.bridge import state_from_numpy
from minigrid_tpu_torch.utils.synthetic import random_states
from torch_port_util import assert_states_equal, to_port

N = 2048
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _front(a, w, h):
    d = a["agent_dir"]
    fx = np.clip(a["agent_x"] + (d == 0) - (d == 2), 0, w - 1)
    fy = np.clip(a["agent_y"] + (d == 1) - (d == 3), 0, h - 1)
    return fx, fy


def _interior(rng, n, w, h):
    return rng.integers(1, w - 1, n), rng.integers(1, h - 1, n)


def _event_states(hook: str, env, rng) -> dict:
    """Random object-rich states of ``env``'s size with the ``extra`` of
    family ``hook``, made so that its events happen often."""
    w, h = env.width, env.height
    a = random_states(rng, (N,), w, h, max_steps=(8, 40))
    rows = np.arange(N)
    fx, fy = _front(a, w, h)
    coin = rng.random(N) < 0.5
    grid, carry = a["grid"], a["carrying"]
    color = rng.integers(0, NUM_COLORS, N)
    if hook == "unlock":
        x, y = _interior(rng, N, w, h)
        x, y = np.where(coin, fx, x), np.where(coin, fy, y)
        grid[rows, x, y] = OBJ_DOOR | (color << 8) | (rng.integers(0, 3, N) << 16)
        carry[:] = np.where(rng.random(N) < 0.5, OBJ_KEY | (color << 8), carry)
        a["extra"] = {"door_pos": np.stack([x, y], -1).astype(np.int32)}
    elif hook == "pickup":
        kind = env.target_kind
        grid[rows, fx, fy] = np.where(coin, kind | (np.where(rng.random(N) < 0.7, color, 0) << 8), grid[rows, fx, fy])
        carry[:] = np.where(rng.random(N) < 0.5, 0, carry)
        a["extra"] = {"target_color": color.astype(np.int32)}
    elif hook == "obstructed_maze":
        grid[rows, fx, fy] = np.where(coin, OBJ_BALL | (COLOR_BLUE << 8), grid[rows, fx, fy])
        carry[:] = np.where(rng.random(N) < 0.5, 0, carry)
    elif hook == "memory":
        x, y = _interior(rng, N, w, h)
        cells = [np.stack([np.where(coin, fx, x), np.where(coin, fy, y)], -1), np.stack(_interior(rng, N, w, h), -1)]
        swap = rng.random(N) < 0.5
        grid[rows, cells[0][:, 0], cells[0][:, 1]] = OBJ_EMPTY
        a["extra"] = {
            "success_pos": np.where(swap[:, None], cells[1], cells[0]).astype(np.int32),
            "failure_pos": np.where(swap[:, None], cells[0], cells[1]).astype(np.int32),
        }
    elif hook == "put_near":
        move_type, move_color = rng.choice([OBJ_KEY, OBJ_BALL], N), color
        carry[:] = np.where(coin, move_type | (move_color << 8), carry)
        grid[rows, fx, fy] = np.where(rng.random(N) < 0.5, OBJ_EMPTY, grid[rows, fx, fy])
        target = np.stack([fx + rng.integers(-2, 3, N), fy + rng.integers(-2, 3, N)], -1)
        a["extra"] = {
            "move_type": move_type.astype(np.int32),
            "move_color": move_color.astype(np.int32),
            "target_pos": target.astype(np.int32),
        }
    elif hook == "red_blue_doors":
        red, blue = np.stack(_interior(rng, N, w, h), -1), np.stack(_interior(rng, N, w, h), -1)
        pick = rng.integers(0, 3, N)
        red = np.where((pick == 0)[:, None], np.stack([fx, fy], -1), red)
        blue = np.where((pick == 1)[:, None], np.stack([fx, fy], -1), blue)
        blue = np.where((red == blue).all(-1)[:, None], red + [[0, 1]], blue).clip(0, [[w - 1, h - 1]])
        grid[rows, red[:, 0], red[:, 1]] = OBJ_DOOR | (COLOR_RED << 8) | (rng.integers(0, 2, N) << 16)
        grid[rows, blue[:, 0], blue[:, 1]] = OBJ_DOOR | (COLOR_BLUE << 8) | (rng.integers(0, 2, N) << 16)
        a["extra"] = {"red_pos": red.astype(np.int32), "blue_pos": blue.astype(np.int32)}
    a["max_steps"][:] = env.max_steps
    a["step_count"] = np.minimum(a["step_count"], env.max_steps - 1).astype(np.int32)
    return a


# (env id, make kwargs, hook): one id per family, KeyCorridor with both of
# its target kinds; the default-hook families step as the core step does.
HOOK_CASES = {
    "unlock": ("MiniGrid-Unlock-v0", {}, "unlock"),
    "unlockpickup": ("MiniGrid-UnlockPickup-v0", {}, "pickup"),
    "blockedunlockpickup": ("MiniGrid-BlockedUnlockPickup-v0", {}, "pickup"),
    "keycorridor_ball": ("MiniGrid-KeyCorridorS3R3-v0", {}, "pickup"),
    "keycorridor_key": ("MiniGrid-KeyCorridorS4R3-v0", {"obj_type": "key"}, "pickup"),
    "obstructedmaze": ("MiniGrid-ObstructedMaze-2Dlh-v0", {}, "obstructed_maze"),
    "memory": ("MiniGrid-MemoryS7-v0", {}, "memory"),
    "putnear": ("MiniGrid-PutNear-6x6-N2-v0", {}, "put_near"),
    "redbluedoors": ("MiniGrid-RedBlueDoors-6x6-v0", {}, "red_blue_doors"),
    "distshift": ("MiniGrid-DistShift2-v0", {}, None),
    "lavagap": ("MiniGrid-LavaGapS6-v0", {}, None),
    "lockedroom": ("MiniGrid-LockedRoom-v0", {}, None),
    "playground": ("MiniGrid-Playground-v0", {}, None),
    "multiroom": ("MiniGrid-MultiRoom-N2-S4-v0", {}, None),
}


@pytest.mark.parametrize("case", list(HOOK_CASES))
def test_step_hooks_match_jax_on_random_transitions(case):
    env_id, kwargs, hook = HOOK_CASES[case]
    jenv, tenv = mg.make(env_id, **kwargs), mgt.make(env_id, **kwargs)
    rng = np.random.default_rng(sorted(HOOK_CASES).index(case))
    arrays = _event_states(hook, tenv, rng)
    actions = rng.integers(0, 7, N).astype(np.int32)
    extra = {k: jnp.asarray(v) for k, v in arrays.get("extra", {}).items()} or None
    fields = {k: jnp.asarray(v) for k, v in arrays.items() if k != "extra"}
    jstate = JState(**fields, rng=jnp.zeros((N, 2), jnp.uint32), extra=extra)
    jnext, jreward = jax.jit(jax.vmap(jenv.step_env))(jstate, jnp.asarray(actions))
    nxt, reward = tenv.step_env(state_from_numpy(arrays, "cpu"), torch.from_numpy(actions))
    assert_states_equal(nxt, jnext, case)
    np.testing.assert_allclose(reward.numpy(), np.asarray(jreward), rtol=1e-6, atol=0)
    if hook is not None:
        # The hooks' events happened: episodes ended past the core step's
        # goal, lava and step limit, and some were rewarded.
        ended = nxt.terminated & ~nxt.truncated
        assert int(ended.sum()) >= N // 100 and int((reward > 0).sum()) >= 8, (int(ended.sum()), int((reward > 0).sum()))


def test_distshift_levels_are_jax_levels():
    for env_id in ("MiniGrid-DistShift1-v0", "MiniGrid-DistShift2-v0"):
        jenv, tenv = mg.make(env_id), mgt.make(env_id)
        jst = jax.jit(jax.vmap(jenv._generate))(jax.random.split(jax.random.PRNGKey(0), 4))
        assert_states_equal(tenv.reset(4, torch.Generator().manual_seed(0))[1], jst, env_id)
        assert_states_equal(to_port(jst), jst, env_id)


@pytest.mark.parametrize("env_id", ["MiniGrid-DistShift1-v0", "MiniGrid-LavaGapS7-v0"])
def test_step_fixture_replays_through_the_family(env_id):
    path = os.path.join(GOLDEN_DIR, f"steps_{env_id}.npz")
    assert golden.replay(path, "cpu", mgt.make(env_id)) >= 300


@pytest.mark.parametrize("env_major", [False, True])
def test_ext_buffers_copy_the_live_scalars(env_major):
    # Both kernels update the ext's scalars in place.  The pickup target
    # packs one scalar, whose [N, 1] pack transposed to the actor kernel's
    # [1, N] is contiguous already: the buffer must still be a copy, or the
    # kernel rewrites the caller's state.  ObstructedMaze's ext has no
    # scalars, and its buffers none.
    env = mgt.make("MiniGrid-BlockedUnlockPickup-v0")
    gen = torch.Generator().manual_seed(0)
    states, cache = env.reset(64, gen)[1], env.batch_reset_cache(64, 2, gen)
    before = states.extra["target_color"].clone()
    ext = fr.ext_buffers(env, states, cache, None, "test", env_major=env_major)
    assert ext.scal.shape == ((64, 1) if env_major else (1, 64)) and ext.scal.is_contiguous()
    ext.scal.add_(1)
    assert torch.equal(states.extra["target_color"], before)
    maze = mgt.make("MiniGrid-ObstructedMaze-2Dlh-v0")
    states, cache = maze.reset(64, gen)[1], maze.batch_reset_cache(64, 2, gen)
    ext = fr.ext_buffers(maze, states, cache, None, "test", env_major=env_major)
    assert ext.scal is None and ext.cscal is None and ext.ext_id == 9
