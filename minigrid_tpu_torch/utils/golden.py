"""Replay the original Minigrid's recorded transitions through the port.

The fixtures in ``tests/golden/`` (written by ``tools/gen_golden.py`` from
the reference) hold batches of one-step transitions: the state before
(``*_pre``), the action, and the state, reward, flags and observation after
(``*_post``, ``obs_image``).  ``steps_*.npz`` exercise the core transition;
``overlay_*.npz`` a family's step hooks, with the family's state recorded as
``extra_*`` arrays.  ``replay`` runs one fixture and raises where the port
differs.  ``replay_wrappers`` holds the 8 wrapper outputs of a
``wrappers_*.npz`` fixture and ``replay_nodeath`` the ``NoDeath`` transitions
of ``nodeath_lava.npz``.  ``replay_verifier`` drives the recorded BabyAI
episodes of a ``verifier_*.npz`` fixture through the rollout kernel one
step at a time.  ``wfc_corpus_check`` measures WFC levels against the
original's corpus ``wfc_ref_corpus.npz``.  None imports JAX, so they also
run on the card.
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


def verifier_episodes(path: str | Path, device="cpu"):
    """The episodes of a ``verifier_[done_]<level id>.npz`` fixture: the
    level id, and per episode its start state [1] with the recorded
    instruction (tests/test_verifier_parity.py's ``_build_instr``), its
    actions, rewards and terminations."""
    from minigrid_tpu_torch.core.roomgrid import RoomGridBuilder
    from minigrid_tpu_torch.envs.babyai.core.instr import empty_instr, set_desc, set_leaf, set_top
    from minigrid_tpu_torch.envs.babyai.core.text import encode_babyai_mission

    d = _load(path)
    name = Path(path).stem
    env_id = name[len("verifier_done_") if name.startswith("verifier_done_") else len("verifier_") :]
    done_mode = bool(d.get("done_mode", False))
    episodes = []
    for i in range(int(d["num_eps"])):
        rec = {k[len(f"ep{i}_") :]: v for k, v in d.items() if k.startswith(f"ep{i}_")}
        grid = torch.from_numpy(rec["grid"][None]).to(device)
        state = new_state(grid, torch.from_numpy(rec["pos"]).to(device), int(rec["dir"]), int(rec["max_steps"]))
        room = None
        if int(rec["room_size"]) > 0:
            b = RoomGridBuilder(int(rec["room_size"]), int(rec["num_rows"]), int(rec["num_cols"]))
            room = b.room_interior_mask(*b.room_of_pos(state.agent_x, state.agent_y))
        instr = empty_instr(1, *state.grid.shape[1:], device=device, done_mode=done_mode)
        flags = {k: bool(rec[k]) for k in ("a_is_and", "b_is_and", "strict")}
        instr = set_top(instr, int(rec["top"]), **flags)
        leaves = rec["leaves"]  # per leaf: kind, strict, then (type, color, loc) of each descriptor
        for leaf in range(4):
            if (leaves[leaf] == -1).all():
                continue
            instr = set_leaf(instr, leaf, int(leaves[leaf, 0]), strict=bool(leaves[leaf, 1]))
            for slot, first in ((0, 2), (1, 5)):
                if slot == 0 or leaves[leaf, 5] >= 0:
                    desc = [int(v) for v in leaves[leaf, first : first + 3]]
                    args = (state.grid, state.agent_pos, state.agent_dir, *desc)
                    instr = set_desc(instr, leaf, slot, *args, agent_room_mask=room)
        state = state.replace(mission=encode_babyai_mission(instr), extra={"instr": instr})
        episodes.append((state, rec["actions"], rec["rewards"], rec["terminated"]))
    return env_id, episodes


def replay_verifier(path: str | Path, device="cpu") -> int:
    """The recorded episodes of a verifier fixture through the rollout
    kernel on ``device`` (its plain version on the CPU), one step a call
    with the recorded action, each episode alone, its start level as the
    cache: the reward of every step to ``REWARD_RTOL``, and the episode's
    end exactly where it was recorded, terminated unless the step limit
    truncates it there.  Returns the number of steps replayed."""
    from minigrid_tpu_torch.ops.fused_rollout import fused_rollout_core

    env_id, episodes = verifier_episodes(path, device)
    env = mgt.make(env_id)
    name, steps = Path(path).name, 0
    for i, (state, actions, rewards, terminated) in enumerate(episodes):
        if (env.width, env.height) != tuple(state.grid.shape[1:]):
            raise AssertionError(f"{name}: {env_id} is {env.width}x{env.height}, the fixture's grid is not")
        cache = state.map(lambda a: a[:, None])
        for t, action in enumerate(actions):
            truncates = int(state.step_count) + 1 >= int(state.max_steps)
            act = torch.full((1, 1), int(action), dtype=torch.int32, device=device)
            state, reward, done, _, _ = fused_rollout_core(env, state, cache, act, False)
            steps += 1
            if not np.isclose(float(reward), rewards[t], rtol=REWARD_RTOL, atol=0):
                raise AssertionError(f"{name}: episode {i} step {t}: reward {float(reward)} != {rewards[t]}")
            ended = bool(terminated[t]) or truncates
            if bool(int(done)) != ended or (ended and t != len(actions) - 1 and bool(terminated[t])):
                raise AssertionError(f"{name}: episode {i} step {t}: ended {bool(int(done))}, recorded {ended}")
            if ended:
                break
    return steps


def wfc_corpus_check(ours: np.ndarray, ref: np.ndarray) -> tuple[float, float, float, float]:
    """WFC levels' inner wall bitmaps bool [N, w, h] against the reference
    corpus's (``tests/golden/wfc_ref_corpus.npz``, ``<preset>_walls``), by
    the measures of ``tests/test_wfc.py::test_distribution_matches_reference``:
    returns (the total variation distance of the two 16-bin 2x2 wall-block
    distributions, our wall density, the corpus's, the density bound
    max(4 se, 0.04) of the two means).  The test's thresholds: TVD < 0.10
    and |density - corpus density| < the bound."""
    ours, ref = np.asarray(ours, bool), np.asarray(ref, bool)

    def block_hist(w):
        b = w[:, :-1, :-1].astype(int) * 8 + w[:, :-1, 1:] * 4 + w[:, 1:, :-1] * 2 + w[:, 1:, 1:]
        return np.bincount(b.reshape(-1), minlength=16) / b.size

    tvd = 0.5 * np.abs(block_hist(ours) - block_hist(ref)).sum()
    d_ours, d_ref = ours.mean(axis=(1, 2)), ref.mean(axis=(1, 2))
    se = np.sqrt(d_ref.var() / len(d_ref) + d_ours.var() / len(d_ours))
    return float(tvd), float(d_ours.mean()), float(d_ref.mean()), float(max(4 * se, 0.04))
