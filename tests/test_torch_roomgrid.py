"""The port's RoomGrid builder (``core/roomgrid.py``) and BabyAI's level base
against the JAX package.

* The deterministic parts bit for bit, on JAX's construction states carried
  across as numpy: ``reach_mask``, ``_room_components``, ``door_slot`` and
  ``wall_open`` on every wall of every room, ``open_all_doors``,
  ``agent_room_mask``, and ``RoomGridLevel.check_objs_reachable``.  The
  states are 3x3 lattices with the agent in a random room and three random
  doors, so that some rooms are cut off.
* The drawing parts by distribution (the pattern of
  tests/test_torch_generators.py: 4096 levels a side, histograms within 25%
  and 3 standard errors, bins above 1%): ``connect_all`` and 18
  ``add_distractors`` on the 3x3 lattice, as BabyAI-GoTo builds it (doors
  per level and their colors, object pairs, the room and the cell of each
  object, every room reachable), and BabyAI-GoToLocal's whole generator
  against JAX's ``_generate`` (objects, cells, the agent's pose, the
  target).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import minigrid_tpu as mg
import minigrid_tpu_torch as mgt
from minigrid_tpu.core.roomgrid import RoomGridBuilder as JBuilder
from minigrid_tpu.core.sampling import randint as j_randint
from minigrid_tpu_torch.core.constants import OBJ_BALL, OBJ_BOX, OBJ_DOOR, OBJ_KEY
from minigrid_tpu_torch.core.roomgrid import RoomGridBuilder, RoomGridState
from minigrid_tpu_torch.utils.bridge import state_to_numpy
from test_counter_reset import _assert_close_freq
from torch_port_util import jax_to_numpy

N = 4096
ROOM, ROWS, COLS = 8, 3, 3


def _port_state(js) -> RoomGridState:
    return RoomGridState(**{f: torch.from_numpy(np.array(getattr(js, f))) for f in RoomGridState.__dataclass_fields__})


@pytest.fixture(scope="module")
def lattice():
    """256 JAX lattices: agent in a random room, three doors on random
    walls of random rooms."""
    b = JBuilder(ROOM, ROWS, COLS)

    def build(key):
        keys = jax.random.split(key, 8)
        s = b.place_agent(keys[1], b.init(keys[0]))
        for d in range(3):
            i, j = j_randint(keys[2 + 2 * d], 0, COLS), j_randint(keys[3 + 2 * d], 0, ROWS)
            s, _, _ = b.add_door(jax.random.fold_in(keys[7], d), s, i, j)
        return s

    js = jax.jit(jax.vmap(build))(jax.random.split(jax.random.PRNGKey(3), 256))
    return b, js, _port_state(js)


def test_deterministic_functions_are_bit_exact(lattice):
    jb, js, s = lattice
    b = RoomGridBuilder(ROOM, ROWS, COLS)
    reach = jax.vmap(jb.reach_mask)(js)
    assert 0 < int(np.asarray(reach).sum()) < reach.size  # some rooms cut off
    np.testing.assert_array_equal(b.reach_mask(s).numpy(), np.asarray(reach))
    np.testing.assert_array_equal(b._room_components(s).numpy(), np.asarray(jax.vmap(jb._room_components)(js)))
    np.testing.assert_array_equal(b.open_all_doors(s).grid.numpy(), np.asarray(jax.vmap(jb.open_all_doors)(js).grid))
    np.testing.assert_array_equal(b.agent_room_mask(s).numpy(), np.asarray(jax.vmap(jb.agent_room_mask)(js)))
    # The construction steps that draw nothing when every choice is given.
    given = ((0, 0, 0), (1, 1, 1), (2, 1, 2), (1, 2, 3))
    built = jax.jit(
        jax.vmap(
            lambda st: [
                (jb.remove_wall(st, *w), jb.add_door(jax.random.PRNGKey(0), st, *w, 2, True)) for w in given
            ]
        )
    )(js)
    for (i, j, k), (removed, (want, _, pos)) in zip(given, built):
        np.testing.assert_array_equal(b.remove_wall(s, i, j, k).grid.numpy(), np.asarray(removed.grid))
        np.testing.assert_array_equal(b.remove_wall(s, i, j, k).open_down.numpy(), np.asarray(removed.open_down))
        got, _, got_pos = b.add_door(None, s, i, j, k, 2, True)
        for name in ("grid", "open_right", "open_down", "locked"):
            np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
        np.testing.assert_array_equal(got_pos.numpy(), np.asarray(pos))
    walls = [(i, j, k) for i in range(-1, COLS + 1) for j in range(-1, ROWS + 1) for k in range(4)]
    slots = jax.jit(jax.vmap(lambda st: [jb.door_slot(st, *w) + (jb.wall_open(st, *w),) for w in walls]))(js)
    for wall, want in zip(walls, slots):
        got = b.door_slot(s, *wall) + (b.wall_open(s, *wall),)
        for name, a, w in zip(("x", "y", "valid", "oi", "oj", "horizontal", "open"), got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(w), err_msg=f"door_slot{wall} {name}")


def test_objects_reachable_is_bit_exact():
    # GoTo's attempts (doors, 18 objects), some of which the flood rejects.
    jenv, tenv = mg.make("BabyAI-GoTo-v0"), mgt.make("BabyAI-GoTo-v0")
    js, _, _ = jax.jit(jax.vmap(jenv.gen_attempt))(jax.random.split(jax.random.PRNGKey(4), 512))
    want = np.asarray(jax.vmap(jenv.check_objs_reachable)(js))
    assert 0 < want.sum() < want.size
    np.testing.assert_array_equal(tenv.check_objs_reachable(_port_state(js)).numpy(), want)


def test_unblocking_levels_reject_a_key_of_a_locked_door_color():
    # The reference's unblocking check (roomgrid_level.py:149-191): an
    # instruction naming a key of the color of a locked door is rejected.
    env = mgt.make("BabyAI-GoToLocal-v0")
    gen = torch.Generator().manual_seed(8)
    s, instr, _ = env.gen_attempt(gen, 64, "cpu")
    b = env.builder
    # A locked yellow door (color 4) on the room's wall.
    s, _, _ = b.add_door(gen, s, 0, 0, None, color=4, locked=True)
    keyed = instr.replace(d_type=instr.d_type.clone(), d_color=instr.d_color.clone())
    keyed.d_type[:, 0, 0], keyed.d_color[:, 0, 0] = OBJ_KEY, 4
    before = env._validate(s, instr), env._validate(s, keyed)
    assert bool(before[1].any())
    env.unblocking = True
    names_yellow_key = (instr.d_type[:, 0, 0] == OBJ_KEY) & (instr.d_color[:, 0, 0] == 4)
    assert torch.equal(env._validate(s, instr), before[0] & ~names_yellow_key)
    assert not bool(env._validate(s, keyed).any())


def _maze_features(grid, open_right, open_down, kinds, colors, positions):
    h = grid.shape[-1]
    types = grid & 0xFF
    doors = types == OBJ_DOOR
    door_colors = ((grid >> 8) & 0xFF)[doors]
    kind_idx = np.searchsorted(np.asarray([OBJ_KEY, OBJ_BALL, OBJ_BOX]), kinds)
    rs = ROOM - 1
    room = (positions[..., 1] // rs) * COLS + positions[..., 0] // rs
    return {
        "doors per level": (doors.reshape(doors.shape[0], -1).sum(axis=1), 4 * ROWS * COLS),
        "door color": (door_colors, 6),
        "open slots per level": ((open_right | open_down).reshape(open_right.shape[0], -1).sum(axis=1), 2 * ROWS * COLS),
        "object pair": (kind_idx * 6 + colors, 18),
        "object room": (room, ROWS * COLS),
        "object cell": (positions[..., 0] * h + positions[..., 1], grid.shape[1] * h),
    }


def test_connect_all_and_distractors_match_jax_by_distribution():
    jb, b = JBuilder(ROOM, ROWS, COLS), RoomGridBuilder(ROOM, ROWS, COLS)

    def build(key):
        keys = jax.random.split(key, 4)
        s = jb.connect_all(keys[2], jb.place_agent(keys[1], jb.init(keys[0])))
        return jb.add_distractors(keys[3], s, num_distractors=18, all_unique=False)

    js, jk, jc, jp = jax.jit(jax.vmap(build))(jax.random.split(jax.random.PRNGKey(5), N))
    gen = torch.Generator().manual_seed(5)
    s = b.connect_all(gen, b.place_agent(gen, b.init(gen, N, "cpu")))
    assert bool(b.reach_mask(s).all())  # every room reachable
    s, kinds, colors, positions = b.add_distractors(gen, s, num_distractors=18, all_unique=False)
    want = _maze_features(*(np.asarray(x) for x in (js.grid, js.open_right, js.open_down, jk, jc, jp)))
    got = _maze_features(*(x.numpy() for x in (s.grid, s.open_right, s.open_down, kinds, colors, positions)))
    for name, (values, bins) in want.items():
        # Frequencies per object (or door) where a level has several.
        _assert_close_freq(
            np.bincount(got[name][0].reshape(-1), minlength=bins), np.bincount(values.reshape(-1), minlength=bins), values.size
        )
    # The objects are where the grid says, on 18 distinct free cells.
    cells = positions[..., 0] * s.grid.shape[-1] + positions[..., 1]
    assert bool((cells.sort(dim=1).values.diff(dim=1) > 0).all())
    placed = s.grid.reshape(N, -1).gather(1, cells.long())
    assert torch.equal(placed, kinds | (colors << 8)) and bool(s.ok.all())


def test_unique_distractors_take_distinct_pairs():
    b = RoomGridBuilder(ROOM, 1, 1)
    gen = torch.Generator().manual_seed(6)
    s = b.place_agent(gen, b.init(gen, 512, "cpu"), 0, 0)
    s, kinds, colors, _ = b.add_distractors(gen, s, num_distractors=10)
    pairs = kinds * 8 + colors
    assert bool((pairs.sort(dim=1).values.diff(dim=1) > 0).all())
    assert bool((s.combo_present.sum(dim=1) == 10).all())


def _local_features(st, w, h):
    types = st["grid"] & 0xFF
    is_obj = np.isin(types, [OBJ_KEY, OBJ_BALL, OBJ_BOX])
    kind_idx = np.searchsorted(np.asarray([OBJ_KEY, OBJ_BALL, OBJ_BOX]), types[is_obj])
    pairs = kind_idx * 6 + ((st["grid"] >> 8) & 0xFF)[is_obj]
    instr = st["extra"]["instr"]
    d_type = np.asarray(instr["d_type"] if isinstance(instr, dict) else instr.d_type)[:, 0, 0]
    d_color = np.asarray(instr["d_color"] if isinstance(instr, dict) else instr.d_color)[:, 0, 0]
    return {
        "object pair": (pairs, 18),
        "object cell": (np.nonzero(is_obj.reshape(is_obj.shape[0], -1))[1], w * h),
        "objects per level": (is_obj.reshape(is_obj.shape[0], -1).sum(axis=1), 10),
        "agent cell": (st["agent_x"] * h + st["agent_y"], w * h),
        "direction": (st["agent_dir"], 4),
        "target": (np.searchsorted(np.asarray([OBJ_KEY, OBJ_BALL, OBJ_BOX]), d_type) * 6 + d_color, 18),
        "max steps": (st["max_steps"] // 64, 4),
    }


def test_gotolocal_generator_matches_jax_by_distribution():
    env_id = "BabyAI-GoToLocal-v0"
    jenv, tenv = mg.make(env_id), mgt.make(env_id)
    _, jst = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(7), N))
    _, tst = tenv.reset(N, torch.Generator().manual_seed(7))
    want = _local_features(jax_to_numpy(jst), jenv.width, jenv.height)
    got = _local_features(state_to_numpy(tst), tenv.width, tenv.height)
    for name, (values, bins) in want.items():
        _assert_close_freq(np.bincount(got[name][0], minlength=bins), np.bincount(values, minlength=bins), values.size)
