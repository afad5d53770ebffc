"""Random object-rich environment states, made with numpy from a seed.

No registered family of this package puts objects in its grids, so these
states exercise what such families would: interior walls; locked, closed
and open doors; keys, balls, boxes with and without contents; goals and
lava; agents that already carry something; short episode limits so that
episodes end and reset.  They feed the kernel-against-plain-version checks
(``chip_smoke.py``) and the CPU tests against the JAX package.  Arrays are
returned as a mapping of field name to numpy array, the input of
``utils/bridge.state_from_numpy``.
"""

from __future__ import annotations

import numpy as np

from minigrid_tpu_torch.core.constants import (
    NUM_COLORS,
    OBJ_BALL,
    OBJ_BOX,
    OBJ_DOOR,
    OBJ_EMPTY,
    OBJ_GOAL,
    OBJ_KEY,
    OBJ_LAVA,
    WALL_CELL,
)
from minigrid_tpu_torch.core.mission import TEMPLATES
from minigrid_tpu_torch.core.state import MISSION_DIM

# Interior cell kinds and their odds.
_KINDS = ("empty", "wall", "door", "key", "ball", "box", "goal", "lava")
_ODDS = (0.5, 0.12, 0.12, 0.08, 0.06, 0.06, 0.04, 0.02)


def random_states(
    rng: np.random.Generator,
    shape: tuple[int, ...],
    width: int,
    height: int,
    max_steps: tuple[int, int] = (4, 16),
    fresh: bool = False,
) -> dict[str, np.ndarray]:
    """States with leading axes ``shape`` ((N,) for states, (N, R) for a
    reset cache).  ``max_steps`` is drawn from the half-open range given;
    ``fresh`` states start at step 0, others part-way through an episode."""
    n = int(np.prod(shape))
    w, h = width, height
    color = rng.integers(0, NUM_COLORS, (n, w, h))
    kind = rng.choice(len(_KINDS), size=(n, w, h), p=_ODDS)
    door_state = rng.integers(0, 3, (n, w, h))
    cells = {
        "empty": np.full((n, w, h), OBJ_EMPTY),
        "wall": np.full((n, w, h), WALL_CELL),
        "door": OBJ_DOOR | (color << 8) | (door_state << 16),
        "key": OBJ_KEY | (color << 8),
        "ball": OBJ_BALL | (color << 8),
        "box": OBJ_BOX | (color << 8),
        "goal": np.full((n, w, h), OBJ_GOAL | (1 << 8)),
        "lava": np.full((n, w, h), OBJ_LAVA),
    }
    grid = np.choose(kind, [cells[k] for k in _KINDS])
    grid[:, 0, :] = grid[:, -1, :] = grid[:, :, 0] = grid[:, :, -1] = WALL_CELL
    # Half of the boxes hide a key or a ball.
    hidden = rng.choice([OBJ_KEY, OBJ_BALL], size=(n, w, h)) | (
        rng.integers(0, NUM_COLORS, (n, w, h)) << 8
    )
    has = ((grid & 0xFF) == OBJ_BOX) & (rng.random((n, w, h)) < 0.5)
    contains = np.where(has, hidden, 0)

    ax = rng.integers(1, w - 1, n)
    ay = rng.integers(1, h - 1, n)
    rows = np.arange(n)
    grid[rows, ax, ay] = OBJ_EMPTY
    contains[rows, ax, ay] = 0

    # Two in five agents carry a key, a ball or a (maybe filled) box.
    carry_type = rng.choice([OBJ_KEY, OBJ_BALL, OBJ_BOX], size=n)
    carry_inner = np.where(
        (carry_type == OBJ_BOX) & (rng.random(n) < 0.5),
        OBJ_KEY | (rng.integers(0, NUM_COLORS, n) << 8),
        0,
    )
    carrying = carry_type | (rng.integers(0, NUM_COLORS, n) << 8) | (carry_inner << 16)
    carrying = np.where(rng.random(n) < 0.4, carrying, 0)

    limit = rng.integers(max_steps[0], max_steps[1], n)
    step_count = np.zeros(n, np.int64) if fresh else rng.integers(0, limit)
    mission = rng.integers(0, NUM_COLORS, (n, MISSION_DIM))
    mission[:, 0] = rng.integers(0, len(TEMPLATES), n)

    out = {
        "grid": grid,
        "contains": contains,
        "agent_x": ax,
        "agent_y": ay,
        "agent_dir": rng.integers(0, 4, n),
        "carrying": carrying,
        "step_count": step_count,
        "max_steps": limit,
        "terminated": np.zeros(n, bool),
        "truncated": np.zeros(n, bool),
        "mission": mission,
    }
    return {
        k: v.reshape(shape + v.shape[1:]).astype(bool if v.dtype == bool else np.int32)
        for k, v in out.items()
    }
