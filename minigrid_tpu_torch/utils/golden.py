"""Replay the original Minigrid's recorded transitions through the port.

The fixtures in ``tests/golden/`` (written by ``tools/gen_golden.py`` from
the reference) hold batches of one-step transitions: the state before
(``*_pre``), the action, and the state, reward, flags and observation after
(``*_post``, ``obs_image``).  ``steps_*.npz`` exercise the core transition;
``overlay_*.npz`` a family's step hooks, with the family's state recorded as
``extra_*`` arrays.  ``replay`` runs one fixture and raises where the port
differs; it imports no JAX, so it also runs on the card.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from minigrid_tpu_torch.core.constants import pack_carry, unpack_grid
from minigrid_tpu_torch.core.obs import gen_obs_image
from minigrid_tpu_torch.core.state import new_state
from minigrid_tpu_torch.core.step import core_step

# The reference computed rewards in float64; the port, like the JAX
# package, in float32.
REWARD_RTOL = 1e-6


def replay(path: str | Path, device="cpu", env=None) -> int:
    """Replay fixture ``path`` on ``device``: through ``core_step`` when
    ``env`` is None, else through ``env.step_env`` with the recorded
    ``extra_*`` arrays as the state's ``extra``.  Integers must match
    exactly, rewards to ``REWARD_RTOL``; raises AssertionError otherwise.
    Returns the number of transitions."""
    with np.load(path) as z:
        d = {k: z[k] for k in z.files}
    t = {k: torch.from_numpy(np.array(v)).to(device) for k, v in d.items()}
    extra = {k[len("extra_") :]: v.int() for k, v in t.items() if k.startswith("extra_")} or None
    state = new_state(
        t["grid_pre"], t["pos_pre"], t["dir_pre"], int(d["max_steps"]), contains=t["contains_pre"], extra=extra
    )
    c = t["carry_pre"].int()
    state = state.replace(
        carrying=pack_carry(c[:, 0], c[:, 1], c[:, 2], c[:, 3]), step_count=t["step_count_pre"].int()
    )
    action = t["action"].int()
    state, reward = core_step(state, action) if env is None else env.step_env(state, action)
    got = {
        "grid_post": unpack_grid(state.grid),
        "contains_post": torch.stack([state.contains & 0xFF, (state.contains >> 8) & 0xFF], -1),
        "pos_post": state.agent_pos,
        "dir_post": state.agent_dir,
        "carry_post": torch.stack([(state.carrying >> s) & 0xFF for s in (0, 8, 16, 24)], -1),
        "terminated": state.terminated,
        "truncated": state.truncated,
        "obs_image": gen_obs_image(state, int(d["agent_view_size"]), bool(d["see_through_walls"])),
    }
    name = Path(path).name
    for key, value in got.items():
        want = d[key]
        if not np.array_equal(value.cpu().numpy().astype(want.dtype), want):
            raise AssertionError(f"{name}: {key} differs from the recorded transition")
    if not np.allclose(reward.cpu().numpy(), d["reward"], rtol=REWARD_RTOL, atol=0):
        raise AssertionError(f"{name}: reward differs from the recorded transition")
    return len(d["action"])
