"""BabyAI seed parity of the port (``minigrid_tpu_torch/compat/parity_babyai.py``)
against the JAX package's (``minigrid_tpu/compat/parity_babyai.py``), which
``tests/test_seed_parity_babyai.py`` holds to the original Minigrid: every
``gen_mission`` mirror, the instruction lowering onto the batched
``InstrState`` (verifier planes included), on the CPU, bit for bit.
``ParityRollout`` through the levels' verifier is held in
``tests/test_torch_parity_rollout.py``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import minigrid_tpu_torch as mgt
from minigrid_tpu.compat import parity as jparity
from minigrid_tpu.compat import parity_babyai as jbabyai
from minigrid_tpu_torch.compat import parity as tparity
from minigrid_tpu_torch.compat import parity_babyai as tbabyai
from parity_port_util import assert_reset_parity

SEEDS = (0, 7)


def _gen_mission_name(env) -> str | None:
    for klass in type(env).__mro__:
        if klass.__name__ in tbabyai.BABYAI_GEN_MISSION:
            return klass.__name__
    return None


def _smallest_id_of_each_entry() -> dict[str, str]:
    """For each of the 32 ``gen_mission`` entries, the registered id with
    the smallest grid (the first by name among equals)."""
    best: dict[str, tuple[int, str]] = {}
    for env_id in mgt.registered_ids():
        if not env_id.startswith("BabyAI-"):
            continue
        env = mgt.make(env_id)
        name = _gen_mission_name(env)
        key = (env.width * env.height, env_id)
        if name is not None and key < best.get(name, (1 << 30, "")):
            best[name] = key
    return {name: env_id for name, (_, env_id) in sorted(best.items())}


ENTRY_IDS = _smallest_id_of_each_entry()


def test_every_gen_mission_entry_has_an_id():
    assert list(tbabyai.BABYAI_GEN_MISSION) == list(jbabyai.BABYAI_GEN_MISSION)
    assert len(tbabyai.BABYAI_GEN_MISSION) == 32
    assert sorted(ENTRY_IDS) == sorted(tbabyai.BABYAI_GEN_MISSION)
    # Every BabyAI id resolves to a gen_mission mirror (through the MRO).
    for env_id in mgt.registered_ids():
        if env_id.startswith("BabyAI-"):
            assert tparity._lookup_generator(mgt.make(env_id)) is tbabyai.babyai_parity_gen, env_id


@pytest.mark.parametrize("entry", sorted(ENTRY_IDS))
def test_reset_parity(entry):
    assert_reset_parity(ENTRY_IDS[entry], SEEDS)


def test_a_carrying_level_starts_with_its_object_in_hand():
    """PutNext's Carrying variants lift the object to move after the
    verifier matched it in the grid: ``carrying`` holds it, its cell is
    empty, and its instruction slot is marked carried, as in the JAX
    package's parity reset."""
    env, state = tparity.parity_reset("BabyAI-PutNextS5N2Carrying-v0", 3, device="cpu")
    carried = int(state.carrying[0])
    assert carried != 0
    instr = state.extra["instr"]
    assert bool(instr.carried[0, 0, 0])
    assert not torch.any((state.grid[0] & 0xFFFF) == carried)


def test_lowering_matches_jax_on_hand_built_instructions():
    """``to_instr_state`` of a sequence with an And side, location
    descriptors and a PutNext leaf equals JAX's lowering of the same host
    tree on the same room grid."""
    rng = np.random.default_rng(5)
    rg_t = tparity.HostRoomGrid(7, 2, 2, rng)
    rg_t.place_agent_room(0, 0)
    objs = rg_t.add_distractors(num_distractors=6, all_unique=True)
    H = tbabyai.HDesc
    instr_t = tbabyai.HSeq(
        "after",
        tbabyai.HSeq("and", tbabyai.HAction("goto", H(objs[0][0], loc="front")), tbabyai.HAction("pickup", H(objs[1][0]))),
        tbabyai.HPutNext(H(objs[2][0], objs[2][1]), H(None, objs[3][1], "left")),
    )
    rg_j = jparity.HostRoomGrid(7, 2, 2, np.random.default_rng(0))
    rg_j.grid, rg_j.agent_pos, rg_j.agent_dir = rg_t.grid.copy(), rg_t.agent_pos, rg_t.agent_dir
    J = jbabyai.HDesc
    instr_j = jbabyai.HSeq(
        "after",
        jbabyai.HSeq("and", jbabyai.HAction("goto", J(objs[0][0], loc="front")), jbabyai.HAction("pickup", J(objs[1][0]))),
        jbabyai.HPutNext(J(objs[2][0], objs[2][1]), J(None, objs[3][1], "left")),
    )
    got = tbabyai.to_instr_state(rg_t, instr_t)
    want = jbabyai.to_instr_state(rg_j, instr_j)
    for name in got.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(got, name)[0].numpy(), np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_array_equal(
        tbabyai.encode_babyai_mission(got)[0].numpy(), np.asarray(jbabyai.encode_babyai_mission(want))
    )
