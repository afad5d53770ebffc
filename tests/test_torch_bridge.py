"""The PyTorch port's state bridge, constants and mission table against the
JAX package, and the port's independence from JAX."""

from __future__ import annotations

import subprocess
import sys

import jax
import numpy as np
import pytest

import minigrid_tpu as mg
from minigrid_tpu.core import constants as jc
from minigrid_tpu.core import mission as jm
from minigrid_tpu_torch.core import constants as tc
from minigrid_tpu_torch.core import mission as tm
from minigrid_tpu_torch.core.state import FIELDS
from minigrid_tpu_torch.utils.bridge import state_from_numpy, state_to_numpy
from torch_port_util import jax_to_numpy


@pytest.mark.parametrize("which", ["state", "cache"])
def test_bridge_round_trip_doorkey(which):
    env = mg.make("MiniGrid-DoorKey-5x5-v0")
    key = jax.random.PRNGKey(0)
    if which == "state":
        _, jstate = jax.jit(jax.vmap(env.reset))(jax.random.split(key, 64))
        lead = (64,)
    else:
        jstate = env.batch_reset_cache(key, 16, 2)
        lead = (16, 2)
    arrays = jax_to_numpy(jstate)
    port = state_from_numpy(arrays)
    assert port.grid.shape == lead + (5, 5) and port.mission.shape == lead + (8,)
    back = state_to_numpy(port)
    for f in FIELDS:
        assert back[f].dtype == arrays[f].dtype, f
        np.testing.assert_array_equal(back[f], arrays[f], err_msg=f)


def test_bridge_ignores_rng_and_requires_every_field():
    env = mg.make("MiniGrid-DoorKey-5x5-v0")
    _, jstate = jax.jit(jax.vmap(env.reset))(jax.random.split(jax.random.PRNGKey(1), 8))
    arrays = dict(jax_to_numpy(jstate), rng=np.asarray(jstate.rng))
    assert not hasattr(state_from_numpy(arrays), "rng")
    del arrays["mission"]
    with pytest.raises(KeyError, match="mission"):
        state_from_numpy(arrays)


CONSTANTS = [
    "OBJ_UNSEEN", "OBJ_EMPTY", "OBJ_WALL", "OBJ_FLOOR", "OBJ_DOOR", "OBJ_KEY",
    "OBJ_BALL", "OBJ_BOX", "OBJ_GOAL", "OBJ_LAVA", "OBJ_AGENT", "NUM_OBJECTS",
    "NUM_COLORS", "STATE_OPEN", "STATE_CLOSED", "STATE_LOCKED", "EMPTY_CELL",
    "WALL_CELL", "UNSEEN_CELL", "GOAL_CELL", "LAVA_CELL", "FLOOR_CELL",
]


def test_constants_match_jax():
    for name in CONSTANTS:
        assert int(getattr(tc, name)) == int(getattr(jc, name)), name
    assert tc.OBJECT_TO_IDX == jc.OBJECT_TO_IDX
    assert tc.COLOR_TO_IDX == jc.COLOR_TO_IDX
    assert np.array_equal(np.asarray(tc.DIR_TO_VEC), np.asarray(jc.DIR_TO_VEC))
    assert tc.pack_carry(5, 3, 7, 2) == int(jc.pack_carry(5, 3, 7, 2))


def test_mission_table_matches_jax():
    assert list(tm.TEMPLATES) == list(jm._TEMPLATES)
    empty = tm.template_id("get to the green goal square")
    assert empty == 2
    from minigrid_tpu.envs.empty import _MISSION

    assert empty == _MISSION
    vec = tm.mission_vec(empty)
    np.testing.assert_array_equal(vec.numpy(), np.asarray(jm.mission_vec(_MISSION)))
    mv = np.array([19, 0, 5, 2, 6, 0, 0, 0], np.int32)
    assert tm.mission_to_text(mv) == jm.mission_to_text(mv)


def test_port_imports_no_jax():
    code = (
        "import sys, minigrid_tpu_torch, minigrid_tpu_torch.parallel.vector, "
        "minigrid_tpu_torch.utils.bridge, minigrid_tpu_torch.utils.synthetic; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'minigrid_tpu')]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
