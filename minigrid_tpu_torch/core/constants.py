"""Integer vocabularies, cell packing and object predicates.

Same encoding contract as ``minigrid_tpu/core/constants.py`` (itself the
reference's minigrid/core/constants.py:1-58): one grid cell is ONE int32,
``type | color << 8 | state << 16``.  The predicates are elementwise
comparisons on int32 tensors, so they run on any device with no lookup
table to move there.  Packed constants are Python ints.
"""

from __future__ import annotations

import numpy as np
import torch

# Pixels per tile of a rendered frame (reference: minigrid/core/constants.py:3).
TILE_PIXELS = 32

# -- Object types (reference: minigrid/core/constants.py:25-37) --
OBJ_UNSEEN = 0
OBJ_EMPTY = 1
OBJ_WALL = 2
OBJ_FLOOR = 3
OBJ_DOOR = 4
OBJ_KEY = 5
OBJ_BALL = 6
OBJ_BOX = 7
OBJ_GOAL = 8
OBJ_LAVA = 9
OBJ_AGENT = 10
NUM_OBJECTS = 11

OBJECT_TO_IDX = {
    "unseen": OBJ_UNSEEN,
    "empty": OBJ_EMPTY,
    "wall": OBJ_WALL,
    "floor": OBJ_FLOOR,
    "door": OBJ_DOOR,
    "key": OBJ_KEY,
    "ball": OBJ_BALL,
    "box": OBJ_BOX,
    "goal": OBJ_GOAL,
    "lava": OBJ_LAVA,
    "agent": OBJ_AGENT,
}
IDX_TO_OBJECT = {v: k for k, v in OBJECT_TO_IDX.items()}

# -- Colors (reference: minigrid/core/constants.py:8-22) --
COLOR_RED = 0
COLOR_GREEN = 1
COLOR_BLUE = 2
COLOR_PURPLE = 3
COLOR_YELLOW = 4
COLOR_GREY = 5
NUM_COLORS = 6

COLOR_TO_IDX = {"red": 0, "green": 1, "blue": 2, "purple": 3, "yellow": 4, "grey": 5}
IDX_TO_COLOR = {v: k for k, v in COLOR_TO_IDX.items()}
# Their RGB values (reference: minigrid/core/constants.py:8-15), for the
# renderer's tile atlas.
COLORS_RGB = np.array(
    [
        [255, 0, 0],  # red
        [0, 255, 0],  # green
        [0, 0, 255],  # blue
        [112, 39, 195],  # purple
        [255, 255, 0],  # yellow
        [100, 100, 100],  # grey
    ],
    dtype=np.uint8,
)
# The reference draws colors from the sorted name list
# (minigrid/core/constants.py:17): SORTED_COLOR_IDX[i] is the index of the
# i-th sorted name (blue, green, grey, purple, red, yellow).
SORTED_COLOR_IDX = tuple(COLOR_TO_IDX[c] for c in sorted(COLOR_TO_IDX))

# -- Door states (reference: minigrid/core/constants.py:42-46) --
STATE_OPEN = 0
STATE_CLOSED = 1
STATE_LOCKED = 2
STATE_TO_IDX = {"open": 0, "closed": 1, "locked": 2}

# -- Directions: 0 east (+x), 1 south (+y), 2 west (-x), 3 north (-y)
# (reference: minigrid/core/constants.py:49-58) --
DIR_TO_VEC = ((1, 0), (0, 1), (-1, 0), (0, -1))


def dir_vec(d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``DIR_TO_VEC[d]`` as two int32 tensors, computed without a table."""
    dx = (d == 0).int() - (d == 2).int()
    dy = (d == 1).int() - (d == 3).int()
    return dx, dy


def can_overlap(t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Whether the agent may step onto a cell of type ``t`` and state ``s``
    (reference: minigrid/core/world_object.py:114, :129, :143, :178-180)."""
    return (
        (t == OBJ_EMPTY)
        | (t == OBJ_FLOOR)
        | (t == OBJ_GOAL)
        | (t == OBJ_LAVA)
        | ((t == OBJ_DOOR) & (s == STATE_OPEN))
    )


def can_pickup(t: torch.Tensor) -> torch.Tensor:
    """Keys, balls and boxes (reference: minigrid/core/world_object.py:244,
    :266, :278)."""
    return (t == OBJ_KEY) | (t == OBJ_BALL) | (t == OBJ_BOX)


def see_behind(t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Light passes everything but walls and doors that are not open
    (reference: minigrid/core/world_object.py:165-166, :182-183)."""
    return ~((t == OBJ_WALL) | ((t == OBJ_DOOR) & (s != STATE_OPEN)))


def cell(obj_type, color=0, state=0):
    """Pack (type, color, state) into one int32 (ints or int32 tensors)."""
    return obj_type | (color << 8) | (state << 16)


def cell_type(packed):
    return packed & 0xFF


def cell_color(packed):
    return (packed >> 8) & 0xFF


def cell_state(packed):
    return (packed >> 16) & 0xFF


def pack_grid(encoded: torch.Tensor) -> torch.Tensor:
    """uint8[..., W, H, 3] reference encoding -> packed int32[..., W, H]."""
    e = encoded.to(torch.int32)
    return e[..., 0] | (e[..., 1] << 8) | (e[..., 2] << 16)


def unpack_grid(packed: torch.Tensor) -> torch.Tensor:
    """Packed int32[..., W, H] -> reference uint8[..., W, H, 3] encoding."""
    return torch.stack(
        [cell_type(packed), cell_color(packed), cell_state(packed)], dim=-1
    ).to(torch.uint8)


def pack_carry(t, c=0, ct=0, cc=0):
    """Carried-object word: type | color << 8 | contents type << 16 |
    contents color << 24 (the reference's ``carrying`` pointer plus
    ``Box.contains``, minigrid/core/world_object.py:274)."""
    return t | (c << 8) | (ct << 16) | (cc << 24)


EMPTY_CELL = cell(OBJ_EMPTY)
WALL_CELL = cell(OBJ_WALL, COLOR_GREY)
UNSEEN_CELL = cell(OBJ_UNSEEN)
GOAL_CELL = cell(OBJ_GOAL, COLOR_GREEN)
LAVA_CELL = cell(OBJ_LAVA, COLOR_RED)
FLOOR_CELL = cell(OBJ_FLOOR, COLOR_BLUE)
