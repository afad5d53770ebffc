"""The port's level generators against the JAX package's ``_generate``, by
distribution.

The port draws its levels from a ``torch.Generator`` and cannot replay
``jax.random``, so for each reset-cache family 4096 levels from each side
are reduced to the features the reference's generator draws (the split
column, the gaps, the objects and their cells, the room size, the door
colors, the mission and its target, the agent's cell and direction), and
the histograms are compared bin by bin with ``_assert_close_freq``
(tests/test_counter_reset.py: 25% relative, 3 standard errors, bins above
1%).  The family's flags and ext shapes must equal the JAX package's."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import minigrid_tpu as mg
import minigrid_tpu_torch as mgt
from minigrid_tpu_torch.core.constants import OBJ_BALL, OBJ_BOX, OBJ_DOOR, OBJ_GOAL, OBJ_KEY, OBJ_LAVA, OBJ_WALL
from test_counter_reset import _assert_close_freq
from torch_port_util import jax_to_numpy

N = 4096


def _hist(values, bins):
    return np.bincount(np.asarray(values).reshape(-1), minlength=bins).astype(float)


def _cells_of(types, kind):
    """Per level, the linear cell index of the one cell of type ``kind``."""
    n = types.shape[0]
    return (types.reshape(n, -1) == kind).argmax(axis=1)


def _doorkey(st, w, h):
    types = st["grid"] & 0xFF
    door = _cells_of(types, OBJ_DOOR)
    return {
        "split column": (door // h, w),
        "door row": (door % h, h),
        "key cell": (_cells_of(types, OBJ_KEY), w * h),
        "agent cell": (st["agent_x"] * h + st["agent_y"], w * h),
        "direction": (st["agent_dir"], 4),
    }


def _fourrooms(st, w, h):
    types = st["grid"] & 0xFF
    rw, rh = w // 2, h // 2
    open_ = types != OBJ_WALL
    return {
        "gap 0": (open_[:, rw, 1:rh].argmax(axis=1), rh),
        "gap 1": (open_[:, 1:rw, rh].argmax(axis=1), rw),
        "gap 2": (open_[:, rw + 1 : 2 * rw, rh].argmax(axis=1), rw),
        "gap 3": (open_[:, rw, rh + 1 : 2 * rh].argmax(axis=1), rh),
        "agent cell": (st["agent_x"] * h + st["agent_y"], w * h),
        "goal cell": (_cells_of(types, OBJ_GOAL), w * h),
        "direction": (st["agent_dir"], 4),
    }


def _objects(st, w, h, kinds):
    """(type, color) pair ids over 3 types x 6 colors, and the occupied
    cells, of every object of the given kinds."""
    types = st["grid"] & 0xFF
    colors = (st["grid"] >> 8) & 0xFF
    is_obj = np.isin(types, kinds)
    kind_idx = np.searchsorted(np.asarray(kinds), types[is_obj])
    pairs = kind_idx * 6 + colors[is_obj]
    occupied = np.nonzero(is_obj.reshape(is_obj.shape[0], -1))[1]
    return pairs, occupied


def _distinct_per_level(values, n):
    """The number of distinct values per level, of ``values`` listed level
    by level with the same count per level."""
    per = np.sort(np.asarray(values).reshape(n, -1), axis=1)
    return 1 + (np.diff(per, axis=1) != 0).sum(axis=1)


def _gotoobject(st, w, h):
    kinds = [OBJ_KEY, OBJ_BALL, OBJ_BOX]
    pairs, occupied = _objects(st, w, h, kinds)
    m = st["mission"]
    target_pair = np.searchsorted(np.asarray(kinds), m[:, 2]) * 6 + m[:, 1]
    tpos = st["extra"]["target_pos"]
    return {
        "object pairs": (pairs, 18),
        "distinct pairs": (_distinct_per_level(pairs, st["grid"].shape[0]), 3),
        "object cells": (occupied, w * h),
        "target pair": (target_pair, 18),
        "target cell": (tpos[:, 0] * h + tpos[:, 1], w * h),
        "mission template": (m[:, 0], 32),
        "agent cell": (st["agent_x"] * h + st["agent_y"], w * h),
        "direction": (st["agent_dir"], 4),
    }


def _gotodoor(st, w, h):
    types = st["grid"] & 0xFF
    colors = (st["grid"] >> 8) & 0xFF
    n = types.shape[0]
    walls = (types == OBJ_WALL) | (types == OBJ_DOOR)
    xs, ys = np.nonzero(walls.any(axis=2)), np.nonzero(walls.any(axis=1))
    rw = np.zeros(n, int)
    rh = np.zeros(n, int)
    np.maximum.at(rw, xs[0], xs[1] + 1)
    np.maximum.at(rh, ys[0], ys[1] + 1)
    env_i, dx, dy = np.nonzero(types == OBJ_DOOR)
    side = np.where(dy == 0, 0, np.where(dy == rh[env_i] - 1, 1, np.where(dx == 0, 2, 3)))
    along = np.where(side < 2, dx, dy)
    tpos = st["extra"]["target_pos"]
    tx, ty = tpos[:, 0], tpos[:, 1]
    tside = np.where(ty == 0, 0, np.where(ty == rh - 1, 1, np.where(tx == 0, 2, 3)))
    return {
        "room width": (rw, w + 1),
        "room height": (rh, h + 1),
        "door position per side": (side * max(w, h) + along, 4 * max(w, h)),
        "door color per side": (side * 6 + colors[env_i, dx, dy], 24),
        "distinct door colors": (_distinct_per_level(colors[env_i, dx, dy], n), 5),
        "target side": (tside, 4),
        "target color": (st["mission"][:, 1], 6),
        "agent cell": (st["agent_x"] * h + st["agent_y"], w * h),
    }


def _fetch(st, w, h):
    kinds = [OBJ_KEY, OBJ_BALL]
    pairs, occupied = _objects(st, w, h, kinds)
    m = st["mission"]
    extra = st["extra"]
    return {
        "object types": (pairs // 6, 2),
        "object colors": (pairs % 6, 6),
        "object cells": (occupied, w * h),
        "syntax": (m[:, 0], 32),
        "target pair": (np.searchsorted(np.asarray(kinds), extra["target_type"]) * 6 + extra["target_color"], 12),
        "mission color": (m[:, 1], 6),
        "agent cell": (st["agent_x"] * h + st["agent_y"], w * h),
    }


def _kind_cells(st, kind):
    """Per level, the sorted linear cells of type ``kind`` ([N, count])."""
    types = st["grid"] & 0xFF
    n = types.shape[0]
    flat = (types.reshape(n, -1) == kind)
    return np.sort(np.where(flat, np.arange(flat.shape[1]), flat.shape[1]), axis=1)[:, : flat.sum(axis=1).max()]


def _color_at(st, cells):
    colors = (st["grid"] >> 8) & 0xFF
    n = colors.shape[0]
    return np.take_along_axis(colors.reshape(n, -1), cells, axis=1)


def _pose(st, w, h):
    return {"agent cell": (st["agent_x"] * h + st["agent_y"], w * h), "direction": (st["agent_dir"], 4)}


def _unlock(st, w, h):
    door, key = _kind_cells(st, OBJ_DOOR)[:, 0], _kind_cells(st, OBJ_KEY)[:, 0]
    door_color = _color_at(st, door[:, None])[:, 0]
    return {
        "door cell": (door, w * h),
        "door color": (door_color, 6),
        "key cell": (key, w * h),
        "key matches door": (_color_at(st, key[:, None])[:, 0] == door_color, 2),
        **_pose(st, w, h),
    }


def _blocked_unlock_pickup(st, w, h):
    box, ball = _kind_cells(st, OBJ_BOX)[:, 0], _kind_cells(st, OBJ_BALL)[:, 0]
    return {
        **_unlock(st, w, h),
        "box cell": (box, w * h),
        "box color": (st["extra"]["target_color"], 6),
        "mission color": (st["mission"][:, 1], 6),
        "ball above the door's left": (ball == _kind_cells(st, OBJ_DOOR)[:, 0] - h, 2),
        "ball color": (_color_at(st, ball[:, None])[:, 0], 6),
    }


def _keycorridor(st, w, h):
    doors = _kind_cells(st, OBJ_DOOR)
    types = st["grid"] & 0xFF
    n = types.shape[0]
    state = (st["grid"] >> 16) & 0xFF
    locked_cell = np.where((types == OBJ_DOOR) & (state == 2), np.arange(w * h).reshape(1, w, h), w * h)
    target = _kind_cells(st, OBJ_BALL)[:, 0]
    return {
        "locked door cell": (locked_cell.reshape(n, -1).min(axis=1), w * h + 1),
        "doors": ((doors < w * h).sum(axis=1), 16),
        "target cell": (target, w * h),
        "target color": (st["extra"]["target_color"], 6),
        "key cell": (_kind_cells(st, OBJ_KEY)[:, 0], w * h),
        **_pose(st, w, h),
    }


def _obstructed_maze(st, w, h):
    boxes = _kind_cells(st, OBJ_BOX)
    n = boxes.shape[0]
    inner = np.take_along_axis(st["contains"].reshape(n, -1), np.minimum(boxes, w * h - 1), axis=1)
    doors = _kind_cells(st, OBJ_DOOR)
    blue = np.where(
        ((st["grid"] & 0xFF) == OBJ_BALL) & (((st["grid"] >> 8) & 0xFF) == 2), np.arange(w * h).reshape(1, w, h), w * h
    )
    return {
        "object box cells": (boxes, w * h),
        "object boxed key colors": ((inner >> 8) & 0xFF, 6),
        "boxed keys": (((inner & 0xFF) == OBJ_KEY).sum(axis=1), 9),
        "doors": ((doors < w * h).sum(axis=1), 13),
        "first door color": (_color_at(st, doors[:, :1])[:, 0], 6),
        "blue ball cell": (blue.reshape(n, -1).min(axis=1), w * h + 1),
        "green balls": ((((st["grid"] & 0xFF) == OBJ_BALL) & (((st["grid"] >> 8) & 0xFF) == 1)).sum(axis=(1, 2)), 9),
        **_pose(st, w, h),
    }


def _lavagap(st, w, h):
    types = st["grid"] & 0xFF
    gap_x = (types == OBJ_LAVA).any(axis=2).argmax(axis=1)
    gap_y = (types[np.arange(types.shape[0]), gap_x] != OBJ_LAVA)[:, 1:].argmax(axis=1) + 1
    return {"gap column": (gap_x, w), "gap row": (gap_y, h), **_pose(st, w, h)}


def _memory(st, w, h):
    types = st["grid"] & 0xFF
    mid = h // 2
    end = (types[:, :, mid - 2] == OBJ_WALL)[:, 5:].argmax(axis=1) + 5  # the vertical hallway's wall
    cue = types[:, 1, mid - 1]
    return {
        "hallway end": (end, w),
        "agent column": (st["agent_x"], w),
        "cue": (cue, 11),
        "upper candidate": (types[np.arange(types.shape[0]), end + 1, mid - 2], 11),
        "success below": (st["extra"]["success_pos"][:, 1] > mid, 2),
        "success matches cue": (
            types[np.arange(types.shape[0]), st["extra"]["success_pos"][:, 0],
                  np.where(st["extra"]["success_pos"][:, 1] > mid, mid + 2, mid - 2)] == cue, 2,
        ),
    }


def _putnear(st, w, h):
    kinds = [OBJ_KEY, OBJ_BALL, OBJ_BOX]
    pairs, occupied = _objects(st, w, h, kinds)
    m, extra = st["mission"], st["extra"]
    tpos = extra["target_pos"]
    return {
        "object pairs": (pairs, 18),
        "object cells": (occupied, w * h),
        "move pair": (np.searchsorted(np.asarray(kinds), extra["move_type"]) * 6 + extra["move_color"], 18),
        "target cell": (tpos[:, 0] * h + tpos[:, 1], w * h),
        "target pair": (np.searchsorted(np.asarray(kinds), m[:, 4]) * 6 + m[:, 3], 18),
        **_pose(st, w, h),
    }


def _redbluedoors(st, w, h):
    extra = st["extra"]
    return {"red row": (extra["red_pos"][:, 1], h), "blue row": (extra["blue_pos"][:, 1], h), **_pose(st, w, h)}


def _lockedroom(st, w, h):
    types = st["grid"] & 0xFF
    doors = _kind_cells(st, OBJ_DOOR)
    state = np.take_along_axis(((st["grid"] >> 16) & 0xFF).reshape(types.shape[0], -1), doors, axis=1)
    return {
        "goal cell": (_cells_of(types, OBJ_GOAL), w * h),
        "key cell": (_cells_of(types, OBJ_KEY), w * h),
        "locked door": ((state == 2).argmax(axis=1), 6),
        "door colors": (_color_at(st, doors)[:, 0], 6),
        "mission key room color": (st["mission"][:, 2], 6),
        **_pose(st, w, h),
    }


def _playground(st, w, h):
    pairs, occupied = _objects(st, w, h, [OBJ_KEY, OBJ_BALL, OBJ_BOX])
    doors = _kind_cells(st, OBJ_DOOR)
    return {
        "object pairs": (pairs, 18),
        "object cells": (occupied, w * h),
        "door cells": (doors, w * h),
        "door colors": (_color_at(st, doors), 6),
        **_pose(st, w, h),
    }


def _multiroom(st, w, h):
    types = st["grid"] & 0xFF
    doors = (types == OBJ_DOOR).sum(axis=(1, 2))
    return {
        "goal cell": (_cells_of(types, OBJ_GOAL), w * h),
        "doors": (doors, 8),
        "walls": ((types == OBJ_WALL).sum(axis=(1, 2)) // 8, w * h // 8),
        "first door color": (_color_at(st, _kind_cells(st, OBJ_DOOR)[:, :1])[:, 0], 6),
        **_pose(st, w, h),
    }


FAMILIES = {
    "MiniGrid-DoorKey-8x8-v0": (_doorkey, 1),
    "MiniGrid-FourRooms-v0": (_fourrooms, 1),
    "MiniGrid-GoToObject-6x6-N2-v0": (_gotoobject, 2),
    "MiniGrid-GoToDoor-8x8-v0": (_gotodoor, 4),
    "MiniGrid-Fetch-8x8-N3-v0": (_fetch, 3),
    "MiniGrid-Unlock-v0": (_unlock, 1),
    "MiniGrid-BlockedUnlockPickup-v0": (_blocked_unlock_pickup, 1),
    "MiniGrid-KeyCorridorS4R3-v0": (_keycorridor, 1),
    "MiniGrid-ObstructedMaze-2Dlh-v0": (_obstructed_maze, 2),
    "MiniGrid-ObstructedMaze-Full-v1": (_obstructed_maze, 8),
    "MiniGrid-LavaGapS7-v0": (_lavagap, 1),
    "MiniGrid-MemoryS13Random-v0": (_memory, 1),
    "MiniGrid-PutNear-8x8-N3-v0": (_putnear, 3),
    "MiniGrid-RedBlueDoors-8x8-v0": (_redbluedoors, 1),
    "MiniGrid-LockedRoom-v0": (_lockedroom, 1),
    "MiniGrid-Playground-v0": (_playground, 12),
    "MiniGrid-MultiRoom-N6-v0": (_multiroom, 1),
}


def _port_numpy(state):
    out = {k: getattr(state, k).numpy() for k in ("grid", "contains", "agent_x", "agent_y", "agent_dir", "mission")}
    out["extra"] = {k: v.numpy() for k, v in (state.extra or {}).items()}
    return out


@pytest.mark.parametrize("env_id", list(FAMILIES))
def test_generator_distribution_matches_jax_generate(env_id):
    features, per_level = FAMILIES[env_id]
    jenv, tenv = mg.make(env_id), mgt.make(env_id)
    _, st = tenv.reset(N, torch.Generator().manual_seed(11))
    jst = jax.jit(jax.vmap(jenv._generate))(jax.random.split(jax.random.PRNGKey(12), N))
    want = jax_to_numpy(jst)
    want.setdefault("extra", {})
    got = _port_numpy(st)
    w, h = tenv.width, tenv.height
    fa, fb = features(got, w, h), features(want, w, h)
    for name, (values, bins) in fa.items():
        # Features counted once per object are compared per object.
        n = N * (per_level if name.startswith(("object", "door ")) else 1)
        assert np.asarray(values).size == n, name
        _assert_close_freq(_hist(values, bins), _hist(fb[name][0], bins), n)
    # Every level is well formed: the family's flags and mission as JAX's.
    assert got["mission"].shape == (N, 8)
    for attr in ("fused_no_objects", "fused_static_mission", "expensive_reset", "see_through_walls", "max_steps"):
        assert getattr(tenv, attr) == getattr(jenv, attr), attr
    jext, text = getattr(jenv, "fused_ext", None), tenv.fused_ext
    assert (jext is None) == (text is None)
    if text is not None:
        assert (text.n_scalars, text.n_planes, text.covers_reset) == (jext.n_scalars, jext.n_planes, jext.covers_reset)
        assert set(got["extra"]) == set(want["extra"])
        for k, v in want["extra"].items():
            assert got["extra"][k].dtype == v.dtype and got["extra"][k].shape == v.shape, k


@pytest.mark.parametrize(
    "env_id",
    ["MiniGrid-ObstructedMaze-2Dlhb-v1", "MiniGrid-ObstructedMaze-1Q-v1", "MiniGrid-ObstructedMaze-2Q-v1",
     "MiniGrid-ObstructedMaze-Full-v1"],
)
def test_obstructed_maze_v1_levels_are_solvable(env_id):
    # tests/test_obstructed_maze.py's check on the port's levels: every
    # locked door's key lies loose or in a box, none under a blocking ball
    # (the v0 fault v1 fixes), and the blue ball is in the level.
    _, st = mgt.make(env_id).reset(512, torch.Generator().manual_seed(3))
    grid, contains = st.grid.numpy(), st.contains.numpy()
    types, colors, states = grid & 0xFF, (grid >> 8) & 0xFF, (grid >> 16) & 0xFF
    for i in range(grid.shape[0]):
        locked = set(colors[i][(types[i] == OBJ_DOOR) & (states[i] == 2)].tolist())
        loose = set(colors[i][types[i] == OBJ_KEY].tolist())
        boxed = set(((contains[i][(contains[i] & 0xFF) == OBJ_KEY] >> 8) & 0xFF).tolist())
        assert locked and locked <= loose | boxed, (i, locked, loose, boxed)
        assert ((types[i] == OBJ_BALL) & (colors[i] == 2)).sum() == 1, i
