"""Host-side state inspection: deterministic state hash and pretty-printing
(reference: minigrid/minigrid_env.py:159-233).

Counterpart of ``minigrid_tpu/utils/debug.py`` over this package's batched
``EnvState`` with a batch of one (a shim's or a parity rollout's state): each
function reads env 0 and copies what it needs to the host once.
"""

from __future__ import annotations

import hashlib

import torch

from minigrid_tpu_torch.core.constants import (
    IDX_TO_COLOR,
    OBJ_DOOR,
    OBJ_EMPTY,
    OBJECT_TO_IDX,
    STATE_LOCKED,
    STATE_OPEN,
    unpack_grid,
)

# Object type -> display char (reference: minigrid_env.py:186-196).
_OBJ_CHAR = {
    OBJECT_TO_IDX["wall"]: "W",
    OBJECT_TO_IDX["floor"]: "F",
    OBJECT_TO_IDX["door"]: "D",
    OBJECT_TO_IDX["key"]: "K",
    OBJECT_TO_IDX["ball"]: "A",
    OBJECT_TO_IDX["box"]: "B",
    OBJECT_TO_IDX["goal"]: "G",
    OBJECT_TO_IDX["lava"]: "V",
}
_DIR_CHAR = {0: ">", 1: "V", 2: "<", 3: "^"}


def _host_view(state):
    """(uint8 [W, H, 3] grid, (x, y), direction) of env 0, as host values."""
    grid = unpack_grid(state.grid[0]).cpu().numpy()
    pose = torch.stack([state.agent_x[0], state.agent_y[0], state.agent_dir[0]]).tolist()
    return grid, (pose[0], pose[1]), pose[2]


def state_hash(state, size: int = 16) -> str:
    """Hash identifying the episode state, same recipe as the reference
    (sha256 over the encoded grid + agent pose, minigrid_env.py:159-169)."""
    grid, pos, direction = _host_view(state)
    h = hashlib.sha256()
    for item in (grid.tolist(), pos, direction):
        h.update(str(item).encode("utf8"))
    return h.hexdigest()[:size]


def pprint_grid(state) -> str:
    """Two-chars-per-cell grid dump with the agent arrow
    (reference: minigrid_env.py:175-233)."""
    grid, pos, direction = _host_view(state)
    w, h = grid.shape[:2]
    rows = []
    for j in range(h):
        line = ""
        for i in range(w):
            if (i, j) == pos:
                line += 2 * _DIR_CHAR[direction]
                continue
            t, c, s = (int(v) for v in grid[i, j])
            if t == OBJ_EMPTY:
                line += "  "
            elif t == OBJ_DOOR:
                if s == STATE_OPEN:
                    line += "__"
                elif s == STATE_LOCKED:
                    line += "L" + IDX_TO_COLOR[c][0].upper()
                else:
                    line += "D" + IDX_TO_COLOR[c][0].upper()
            else:
                line += _OBJ_CHAR[t] + IDX_TO_COLOR[c][0].upper()
        rows.append(line)
    return "\n".join(rows)
