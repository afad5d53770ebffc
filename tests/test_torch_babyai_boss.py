"""BabyAI's BossLevel, BossLevelNoUnlock and GoToSeq in the PyTorch port
(``envs/babyai/levelgen.py``), against the JAX package's valid attempts
(2048 attempts a side, 5 sigma; the rules: ``tests/babyai_port_util.py``),
on their registered 22x22 configurations and GoToSeqS5R2.  The
descriptors the port's ``_rand_obj`` keeps name an object, outside the
locked room where ``implicit_unlock`` is off."""

from __future__ import annotations

import pytest
import torch

from babyai_port_util import compare_generation, jax_generation, one_torch_thread
import minigrid_tpu_torch as mgt
from minigrid_tpu_torch.core.constants import OBJ_DOOR
from minigrid_tpu_torch.envs.babyai.core.instr import desc_match_mask

CLASSES = {
    "BossLevel": "BabyAI-BossLevel-v0",
    "BossLevelNoUnlock": "BabyAI-BossLevelNoUnlock-v0",
    "GoToSeq": "BabyAI-GoToSeqS5R2-v0",
}


@pytest.fixture(scope="module")
def levels():
    return jax_generation(CLASSES)


@pytest.mark.parametrize("cls", list(CLASSES))
def test_generation_matches_jax(levels, cls):
    compare_generation(CLASSES[cls], levels[cls])


@pytest.mark.parametrize("env_id", ["BabyAI-BossLevel-v0", "BabyAI-SynthLoc-v0"])
@one_torch_thread()
def test_kept_descriptors_name_an_object(env_id):
    env = mgt.make(env_id)
    gen = torch.Generator().manual_seed(2)
    s = env.builder.init(gen, 256, "cpu")
    s = env.builder.connect_all(gen, s)
    s, _, _, _ = env.builder.add_distractors(gen, s, num_distractors=6, all_unique=False)
    s = env.builder.place_agent(gen, s)
    room = env.builder.agent_room_mask(s)
    locked = torch.zeros_like(room)
    locked[:, : env.width // 2] = True  # a stand-in locked room: the left half
    have_locked = torch.arange(256) % 2 == 0
    for mode in (0, 1, 2):
        modes = torch.full((256,), mode)
        t, c, loc, ok = env._rand_obj(gen, s, room, modes, locked & have_locked[:, None, None], have_locked)
        mask = desc_match_mask(s.grid, t, c, loc, s.agent_pos, s.agent_dir, room)
        assert torch.equal(ok, mask.flatten(1).any(dim=1) & (env.implicit_unlock | ~have_locked | (mask & ~locked).flatten(1).any(dim=1)))
        assert float(ok.float().mean()) > 0.9, (mode, float(ok.float().mean()))
        if mode == 1:
            assert not bool((t == OBJ_DOOR).any())
        if mode == 2:
            assert bool((t == OBJ_DOOR).all())
