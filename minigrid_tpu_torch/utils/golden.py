"""Replay the original Minigrid's recorded transitions through the port.

The fixtures in ``tests/golden/`` (written by ``tools/gen_golden.py`` from
the reference) hold batches of one-step transitions: the state before
(``*_pre``), the action, and the state, reward, flags and observation after
(``*_post``, ``obs_image``).  ``steps_*.npz`` exercise the core transition;
``overlay_*.npz`` a family's step hooks, with the family's state recorded as
``extra_*`` arrays.  ``replay`` runs one fixture and raises where the port
differs.  ``replay_wrappers`` holds the 8 wrapper outputs of a
``wrappers_*.npz`` fixture and ``replay_nodeath`` the ``NoDeath`` transitions
of ``nodeath_lava.npz``.  None imports JAX, so they also run on the card.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

import minigrid_tpu_torch as mgt
from minigrid_tpu_torch import wrappers as wr
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


def _load(path) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _recorded_states(d: dict, device, max_steps: int, mission=None):
    """The recorded states (``grid``, ``contains``, ``pos``, ``dir``,
    ``carry``, maybe ``step_count``) of a wrapper or NoDeath fixture, on
    ``device``."""
    keys = ("grid", "contains", "pos", "dir", "carry", "step_count")
    t = {k: torch.from_numpy(d[k]).to(device) for k in keys if k in d}
    state = new_state(t["grid"], t["pos"], t["dir"], max_steps, contains=t["contains"], mission=mission)
    c = t["carry"].int()
    state = state.replace(carrying=pack_carry(c[:, 0], c[:, 1], c[:, 2], c[:, 3]))
    if "step_count" in t:
        state = state.replace(step_count=t["step_count"].int())
    return state


def wrapper_cases(env) -> list[tuple[str, object, str | None]]:
    """(fixture key, wrapper, observation field or None) of the 8 recorded
    wrapper outputs (tests/test_wrappers.py's cases)."""
    return [
        ("fully", wr.FullyObsWrapper(env), "image"),
        ("onehot", wr.OneHotPartialObsWrapper(env), "image"),
        ("symbolic", wr.SymbolicObsWrapper(env), "image"),
        ("dict_mission", wr.DictObservationSpaceWrapper(env), "mission"),
        ("flat", wr.FlatObsWrapper(env), None),
        ("view5", wr.ViewSizeWrapper(env, agent_view_size=5), "image"),
        ("rgb_full", wr.RGBImgObsWrapper(env, tile_size=8), "image"),
        ("rgb_pov", wr.RGBImgPartialObsWrapper(env, tile_size=8), "image"),
    ]


def replay_wrappers(path: str | Path, device="cpu", keys=None) -> int:
    """The wrapper outputs of fixture ``wrappers_<env id>.npz`` (all 8, or
    those named in ``keys``) from its recorded states on ``device``,
    exactly; raises AssertionError otherwise.  Returns the number of
    states."""
    d = _load(path)
    name = Path(path).name
    env = mgt.make(name[len("wrappers_") : -len(".npz")])
    n = d["grid"].shape[0]
    # The recorded missions are the family's constant one.
    mission = env.reset(1, torch.Generator().manual_seed(0), "cpu")[1].mission.to(device).expand(n, -1)
    states = _recorded_states(d, device, env.max_steps, mission)
    for key, wrapper, field in wrapper_cases(env):
        if keys is not None and key not in keys:
            continue
        out = wrapper.observation(states)
        got = (out if field is None else out[field]).cpu().numpy()
        want = d[key]
        if got.shape != want.shape or not np.array_equal(got.astype(want.dtype), want):
            raise AssertionError(f"{name}: {key} differs from the recorded wrapper output")
    return n


def replay_nodeath(path: str | Path, device="cpu") -> int:
    """The recorded ``NoDeath(LavaCrossingS9N1, ("lava",))`` transitions of
    ``nodeath_lava.npz`` through ``step_env`` on ``device``: flags exact,
    rewards to ``REWARD_RTOL``.  Returns the number of transitions."""
    d = _load(path)
    env = wr.NoDeath(mgt.make("MiniGrid-LavaCrossingS9N1-v0"), no_death_types=("lava",), death_cost=-1.0)
    action = torch.from_numpy(d["action"]).to(device).int()
    stepped, reward = env.step_env(_recorded_states(d, device, int(d["max_steps"])), action)
    for key, value in (("terminated", stepped.terminated), ("truncated", stepped.truncated)):
        if not np.array_equal(value.cpu().numpy(), d[key]):
            raise AssertionError(f"nodeath: {key} differs from the recorded transition")
    if not np.allclose(reward.cpu().numpy(), d["reward"], rtol=REWARD_RTOL, atol=0):
        raise AssertionError("nodeath: reward differs from the recorded transition")
    if not (d["reward"] < 0).any() or d["terminated"].all():
        raise AssertionError("nodeath: the fixture holds no cancelled death")
    return len(d["action"])
