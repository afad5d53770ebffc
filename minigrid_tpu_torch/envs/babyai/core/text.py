"""BabyAI mission encoding and its surface text.

Counterpart of ``minigrid_tpu/envs/babyai/core/text.py`` (the reference's
``surface()`` methods, minigrid/envs/babyai/core/verifier.py:72-102,
:259-260, :298-299, :329-330, :377-383, :455-456, :496-497, :542-543).

A BabyAI level's mission is an int32 [44] vector:
  [0]  BABYAI_MARKER (-7)
  [1]  top_kind   [2] a_is_and   [3] b_is_and
  [4 + 10*l ...] for leaf l in 0..3: kind, strict, then for each of the two
       descriptors type, color, loc, plural.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core.constants import IDX_TO_COLOR, IDX_TO_OBJECT
from minigrid_tpu_torch.envs.babyai.core.instr import (
    LEAF_GOTO,
    LEAF_OPEN,
    LEAF_PICKUP,
    LEAF_PUTNEXT,
    TOP_ACTION,
    TOP_AFTER,
    TOP_AND,
    TOP_BEFORE,
    InstrState,
)

BABYAI_MARKER = -7
MISSION_LEN = 44
LOC_NAMES = ("left", "right", "front", "behind")


def encode_babyai_mission(instr: InstrState) -> torch.Tensor:
    """int32 [N, MISSION_LEN] mission rows of N instructions."""
    n, device = instr.top_kind.shape[0], instr.top_kind.device
    cols = [
        torch.full((n,), BABYAI_MARKER, dtype=torch.int32, device=device),
        instr.top_kind,
        instr.a_is_and,
        instr.b_is_and,
    ]
    for leaf in range(4):
        cols += [instr.leaf_kind[:, leaf], instr.leaf_strict[:, leaf]]
        for d in range(2):
            cols += [instr.d_type[:, leaf, d], instr.d_color[:, leaf, d], instr.d_loc[:, leaf, d], instr.d_plural[:, leaf, d]]
    return torch.stack([c.to(torch.int32) for c in cols], dim=1)


def _desc_text(type_idx: int, color_idx: int, loc_idx: int, plural: int) -> str:
    s = IDX_TO_OBJECT[type_idx] if type_idx >= 0 else "object"
    if color_idx >= 0:
        s = IDX_TO_COLOR[color_idx] + " " + s
    if loc_idx >= 0:
        loc = LOC_NAMES[loc_idx]
        if loc == "front":
            s += " in front of you"
        elif loc == "behind":
            s += " behind you"
        else:
            s += " on your " + loc
    return ("a " if plural else "the ") + s


def _leaf_text(m: list[int], leaf: int) -> str:
    base = 4 + 10 * leaf
    kind = m[base]
    d0 = _desc_text(*m[base + 2 : base + 6])
    if kind == LEAF_OPEN:
        return "open " + d0
    if kind == LEAF_GOTO:
        return "go to " + d0
    if kind == LEAF_PICKUP:
        return "pick up " + d0
    if kind == LEAF_PUTNEXT:
        return "put " + d0 + " next to " + _desc_text(*m[base + 6 : base + 10])
    return ""


def babyai_mission_text(mission) -> str:
    """The reference's mission string of one mission vector."""
    m = [int(v) for v in mission]
    if m[0] != BABYAI_MARKER:
        raise ValueError(f"not a BabyAI mission vector: slot 0 is {m[0]}, not {BABYAI_MARKER}")
    top, a_is_and, b_is_and = m[1], bool(m[2]), bool(m[3])

    def side(first: int, is_and: bool) -> str:
        text = _leaf_text(m, first)
        return text + " and " + _leaf_text(m, first + 1) if is_and else text

    if top == TOP_ACTION:
        return _leaf_text(m, 0)
    if top == TOP_AND:
        return _leaf_text(m, 0) + " and " + _leaf_text(m, 1)
    a, b = side(0, a_is_and), side(2, b_is_and)
    if top == TOP_BEFORE:
        return a + ", then " + b
    if top == TOP_AFTER:
        return a + " after you " + b
    return a
