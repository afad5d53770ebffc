"""The rollout kernel's plain version on the original Minigrid's recorded
BabyAI episodes (``tests/golden/verifier_*``: 8 levels, normal and
done-actions mode): ``utils/golden.replay_verifier`` drives each episode
from its recorded start state and instruction one step a call with the
recorded action, as ``chip_smoke.py`` phase 24 drives the kernel on the
card.  Every step's reward to rtol 1e-6 and the episode's end exactly where
it was recorded.  The OPEN, PICKUP and PUTNEXT leaves, the And, Before and
After combinators and strict mode all run here.  No JAX."""

from __future__ import annotations

import glob
import os

import numpy as np
import pytest

from babyai_port_util import one_torch_thread
from minigrid_tpu_torch.ops import fused_rollout as fr
from minigrid_tpu_torch.utils import golden

VERIFIER_FILES = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "golden", "verifier_*.npz")))


@pytest.mark.parametrize("path", VERIFIER_FILES, ids=os.path.basename)
@one_torch_thread()
def test_recorded_episodes_replay_through_the_rollout_kernels_plain_version(path):
    before = fr.KERNEL_LAUNCHES
    steps = golden.replay_verifier(path, "cpu")
    assert steps >= 21 and fr.KERNEL_LAUNCHES == before  # CPU tensors: the plain version


def test_replay_fails_on_a_wrong_recorded_reward(tmp_path):
    # A fixture whose first recorded reward of a successful episode is off.
    path = next(p for p in VERIFIER_FILES if os.path.basename(p) == "verifier_BabyAI-GoToLocal-v0.npz")
    with np.load(path) as z:
        d = {k: z[k] for k in z.files}
    ep = next(i for i in range(int(d["num_eps"])) if d[f"ep{i}_rewards"].max() > 0)
    t = int(d[f"ep{ep}_rewards"].argmax())
    d[f"ep{ep}_rewards"] = d[f"ep{ep}_rewards"].copy()
    d[f"ep{ep}_rewards"][t] *= 0.5
    broken = tmp_path / os.path.basename(path)
    np.savez(broken, **d)
    with pytest.raises(AssertionError, match=f"episode {ep} step {t}: reward"):
        golden.replay_verifier(broken, "cpu")
