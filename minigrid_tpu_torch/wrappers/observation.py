"""Observation wrappers (reference: minigrid/wrappers.py).

Counterpart of ``minigrid_tpu/wrappers/observation.py``: each is a transform
of the batched state or of the inner observation, with a leading env axis.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import obs as obs_lib
from minigrid_tpu_torch.core.constants import (
    COLOR_RED,
    NUM_COLORS,
    NUM_OBJECTS,
    OBJ_AGENT,
    OBJ_EMPTY,
    OBJ_GOAL,
    cell,
    cell_type,
    unpack_grid,
)
from minigrid_tpu_torch.core.mission import MINIGRID_WORDS, build_token_tables, mission_word_tokens
from minigrid_tpu_torch.wrappers.base import Wrapper


def _one_hot(x: torch.Tensor, k: int) -> torch.Tensor:
    """uint8 one-hot of ``x`` over [0, k); a value outside is all zeros, as
    ``jax.nn.one_hot`` gives."""
    return (x[..., None] == torch.arange(k, device=x.device)).to(torch.uint8)


class _Tables:
    """A dict of CPU tensors, copied to each device it is asked for once."""

    def __init__(self, tables: dict[str, torch.Tensor]):
        self._on = {torch.device("cpu"): tables}

    def on(self, device) -> dict[str, torch.Tensor]:
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = {k: v.to(device) for k, v in self._on[torch.device("cpu")].items()}
        return self._on[device]


class ImgObsWrapper(Wrapper):
    """The image alone (reference: minigrid/wrappers.py:190-217).

    Example:
        >>> import minigrid_tpu_torch as mgt
        >>> from minigrid_tpu_torch.wrappers import ImgObsWrapper
        >>> obs, _ = ImgObsWrapper(mgt.make("MiniGrid-Empty-5x5-v0")).reset(2, device="cpu")
        >>> tuple(obs.shape)
        (2, 7, 7, 3)
    """

    def observation(self, state):
        return self.env.observation(state)["image"]


class OneHotPartialObsWrapper(Wrapper):
    """[N, v, v, 3] -> [N, v, v, 20]: one-hots of type, color and state
    (reference: minigrid/wrappers.py:220-287)."""

    def observation(self, state, image: bool = True):
        o = self.env.observation(state, image)
        if not image:
            return o
        img = o["image"].long()
        parts = (_one_hot(img[..., 0], NUM_OBJECTS), _one_hot(img[..., 1], NUM_COLORS), _one_hot(img[..., 2], 3))
        return {**o, "image": torch.cat(parts, dim=-1)}


class FullyObsWrapper(Wrapper):
    """The whole grid, uint8 [N, W, H, 3], the agent cell encoded as (agent,
    red, direction) (reference: minigrid/wrappers.py:384-423)."""

    def observation(self, state, image: bool = True):
        o = self.env.observation(state, image=False)
        if not image:
            return o
        grid = state.grid.clone()
        rows = torch.arange(grid.shape[0], device=grid.device)
        grid[rows, state.agent_x.long(), state.agent_y.long()] = cell(OBJ_AGENT, COLOR_RED, state.agent_dir)
        return {"image": unpack_grid(grid), **o}


class DictObservationSpaceWrapper(Wrapper):
    """The mission as word indices of a fixed vocabulary, int32
    [N, max_words] (reference: minigrid/wrappers.py:426-551)."""

    def __init__(self, env, max_words_in_mission: int = 50):
        super().__init__(env)
        self.max_words_in_mission = max_words_in_mission
        self.num_words = len(MINIGRID_WORDS)
        self._tables = _Tables(build_token_tables(max_words_in_mission))

    def observation(self, state, image: bool = True):
        o = self.env.observation(state, image)
        return {**o, "mission": mission_word_tokens(state.mission, self._tables.on(state.mission.device))}


class FlatObsWrapper(Wrapper):
    """The image and a one-hot of the mission string's characters (28 codes,
    ``maxStrLen`` rows) flattened into one uint8 [N, v*v*3 + maxStrLen*28]
    vector (reference: minigrid/wrappers.py:554-621).

    Example:
        >>> import minigrid_tpu_torch as mgt
        >>> from minigrid_tpu_torch.wrappers import FlatObsWrapper
        >>> obs, _ = FlatObsWrapper(mgt.make("MiniGrid-Empty-5x5-v0")).reset(2, device="cpu")
        >>> tuple(obs.shape)  # 7*7*3 image + 96*28 mission chars
        (2, 2835)
    """

    NUM_CHAR_CODES = 28

    def __init__(self, env, maxStrLen: int = 96):
        super().__init__(env)
        self.max_str_len = maxStrLen
        self._tables = _Tables(build_token_tables())
        # Per-word char codes: a-z -> 0-25, space -> 26, comma -> 27
        # (reference :602-608); row 0 is the padding word.
        self._max_word_len = max(len(w) for w in MINIGRID_WORDS)
        chars = torch.zeros((len(MINIGRID_WORDS) + 1, self._max_word_len), dtype=torch.long)
        lens = torch.zeros(len(MINIGRID_WORDS) + 1, dtype=torch.long)
        is_comma = torch.zeros(len(MINIGRID_WORDS) + 1, dtype=torch.bool)
        for i, w in enumerate(MINIGRID_WORDS):
            lens[i + 1] = len(w)
            is_comma[i + 1] = w == ","
            for k, ch in enumerate(w):
                chars[i + 1, k] = 27 if ch == "," else ord(ch) - ord("a")
        self._words = _Tables({"chars": chars, "lens": lens, "is_comma": is_comma})

    def _mission_char_onehot(self, mission: torch.Tensor) -> torch.Tensor:
        device = mission.device
        words = self._words.on(device)
        toks = mission_word_tokens(mission, self._tables.on(device)).long()  # [N, words]
        lens = words["lens"][toks]
        # One space before each word but the first and but commas, which
        # attach to the word before them in the reference's string.
        nonpad = toks > 0
        sep = nonpad & ~words["is_comma"][toks]
        sep[:, 0] = False
        starts = torch.cumsum(lens + sep.long(), dim=1) - lens
        # Which word covers output position p, and at what offset.
        p = torch.arange(self.max_str_len, device=device)
        ends = starts + lens
        in_word = (p[None, None, :] >= starts[..., None]) & (p[None, None, :] < ends[..., None]) & nonpad[..., None]
        word_idx = torch.argmax(in_word.int(), dim=1)  # [N, L], the first covering word
        covered = in_word.any(dim=1)
        offset = p[None, :] - starts.gather(1, word_idx)
        code = words["chars"][toks.gather(1, word_idx), offset.clamp(0, self._max_word_len - 1)]
        total = ends.max(dim=1).values * nonpad.any(dim=1).long()
        # Uncovered positions within the string are spaces (26); past its
        # end, all-zero rows (the reference writes only len(mission) rows).
        code = torch.where(covered, code, 26)
        onehot = _one_hot(code, self.NUM_CHAR_CODES)
        return torch.where((p[None, :] < total[:, None])[..., None], onehot, 0)

    def observation(self, state):
        o = self.env.observation(state)
        n = state.mission.shape[0]
        image = o["image"].reshape(n, -1)
        mission = self._mission_char_onehot(state.mission).reshape(n, -1)
        return torch.cat([image, mission], dim=1).to(torch.uint8)


class ViewSizeWrapper(Wrapper):
    """The symbolic observation at another view size
    (reference: minigrid/wrappers.py:624-668).

    Example:
        >>> import minigrid_tpu_torch as mgt
        >>> from minigrid_tpu_torch.wrappers import ViewSizeWrapper
        >>> env = ViewSizeWrapper(mgt.make("MiniGrid-Empty-5x5-v0"), agent_view_size=5)
        >>> obs, _ = env.reset(2, device="cpu")
        >>> tuple(obs["image"].shape)
        (2, 5, 5, 3)
    """

    def __init__(self, env, agent_view_size: int = 7):
        super().__init__(env)
        if agent_view_size % 2 != 1 or agent_view_size < 3:
            raise ValueError(f"agent_view_size must be odd and >= 3, got {agent_view_size}")
        self.agent_view_size = agent_view_size

    def observation(self, state, image: bool = True):
        o = self.env.observation(state, image=False)
        if not image:
            return o
        return {"image": obs_lib.gen_obs_image(state, self.agent_view_size, self.env.see_through_walls), **o}


class DirectionObsWrapper(Wrapper):
    """Adds the slope (or angle) toward the goal, float32 [N]
    (reference: minigrid/wrappers.py:671-721, its row-major index quirks
    included).

    Deviation, as in the JAX package: the reference keeps the first
    episode's goal position forever; here it is recomputed from each
    observed state (the same for the static-goal envs the wrapper targets).
    """

    def __init__(self, env, type: str = "slope"):
        super().__init__(env)
        if type not in ("slope", "angle"):
            raise ValueError(f"type must be 'slope' or 'angle', got {type!r}")
        self.type = type

    def observation(self, state, image: bool = True):
        o = self.env.observation(state, image)
        n, w, h = state.grid.shape
        device = state.grid.device
        is_goal = cell_type(state.grid) == OBJ_GOAL
        # The reference flattens the row-major cell list and takes
        # (idx // height, idx % width) (minigrid/wrappers.py:697-706).
        ref_idx = torch.arange(h, device=device)[None, :] * w + torch.arange(w, device=device)[:, None]
        flat = torch.where(is_goal, ref_idx, w * h + 1).reshape(n, -1).min(dim=1).values
        goal_x, goal_y = (flat // h).int(), (flat % w).int()
        slope = (goal_y - state.agent_y) / (goal_x - state.agent_x)
        return {**o, "goal_direction": torch.arctan(slope) if self.type == "angle" else slope}


class SymbolicObsWrapper(Wrapper):
    """(x, y, object index) of every cell, int [N, W, H, 3]; empty cells -1,
    the agent cell the agent's index (reference: minigrid/wrappers.py:724-770)."""

    def observation(self, state, image: bool = True):
        o = self.env.observation(state, image=False)
        if not image:
            return o
        n, w, h = state.grid.shape
        device = state.grid.device
        xs = torch.arange(w, dtype=torch.int32, device=device)[None, :, None].expand(n, w, h)
        ys = torch.arange(h, dtype=torch.int32, device=device)[None, None, :].expand(n, w, h)
        obj = cell_type(state.grid)
        obj = torch.where(obj == OBJ_EMPTY, -1, obj)
        here = (xs == state.agent_x[:, None, None]) & (ys == state.agent_y[:, None, None])
        obj = torch.where(here, OBJ_AGENT, obj)
        return {"image": torch.stack([xs, ys, obj], dim=-1), **o}
