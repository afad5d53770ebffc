"""BabyAI's Synth levels in the PyTorch port (``envs/babyai/levelgen.py``):
Synth (SynthS5R2), SynthLoc and SynthSeq against the JAX package's valid
attempts (2048 attempts a side, 5 sigma; the rules:
``tests/babyai_port_util.py``)."""

from __future__ import annotations

import pytest

from babyai_port_util import compare_generation, jax_generation

CLASSES = {"Synth": "BabyAI-SynthS5R2-v0", "SynthLoc": "BabyAI-SynthLoc-v0", "SynthSeq": "BabyAI-SynthSeq-v0"}


@pytest.fixture(scope="module")
def levels():
    return jax_generation(CLASSES)


@pytest.mark.parametrize("cls", list(CLASSES))
def test_generation_matches_jax(levels, cls):
    compare_generation(CLASSES[cls], levels[cls])
