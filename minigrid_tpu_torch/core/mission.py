"""Structured mission encoding: int32[MISSION_DIM] vectors whose slot 0 is a
template id and whose other slots are template parameters.

The JAX package assigns template ids in the order its env modules register
them (``minigrid_tpu/core/mission.py:28-40``).  This package registers only a
few families, so it holds the JAX package's whole table, in that order, and
its ids stay the same: "get to the green goal square" is id 2.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core.constants import IDX_TO_COLOR, IDX_TO_OBJECT
from minigrid_tpu_torch.core.state import MISSION_DIM

PARAM_COLOR = "color"
PARAM_TYPE = "type"
PARAM_INT = "int"

_C, _T = PARAM_COLOR, PARAM_TYPE

# (template, parameter kinds), indexed by template id.
TEMPLATES: tuple[tuple[str, tuple[str, ...]], ...] = (
    ("avoid the lava and get to the green goal square", ()),
    ("find the opening and get to the green goal square", ()),
    ("get to the green goal square", ()),
    ("use the key to open the door and then get to the goal", ()),
    ("get a {0} {1}", (_C, _T)),
    ("go get a {0} {1}", (_C, _T)),
    ("fetch a {0} {1}", (_C, _T)),
    ("go fetch a {0} {1}", (_C, _T)),
    ("you must fetch a {0} {1}", (_C, _T)),
    ("reach the goal", ()),
    ("go to the {0} {1}", (_C, _T)),
    ("go to the {0} door", (_C,)),
    ("go to the matching object at the end of the hallway", ()),
    ("open the door", ()),
    ("pick up the {0} {1}", (_C, _T)),
    (
        "get the {0} key from the {1} room, unlock the {2} door and go to the goal",
        (_C, _C, _C),
    ),
    ("traverse the rooms to get to the goal", ()),
    ("pick up the {0} ball", (_C,)),
    ("", ()),
    ("put the {0} {1} near the {2} {3}", (_C, _T, _C, _T)),
    ("open the red door then the blue door", ()),
    ("traverse the maze to get to the goal", ()),
)
_TEMPLATE_IDS = {t: i for i, t in enumerate(TEMPLATES)}


def template_id(template: str, params: tuple[str, ...] = ()) -> int:
    """The global id of a template (KeyError for one the table lacks)."""
    return _TEMPLATE_IDS[(template, tuple(params))]


def mission_vec(tid: int, *params: int) -> torch.Tensor:
    """int32[MISSION_DIM] mission vector with zeroed unused slots."""
    slots = [tid, *params]
    if len(slots) > MISSION_DIM:
        raise ValueError(f"a mission holds at most {MISSION_DIM - 1} parameters")
    return torch.tensor(slots + [0] * (MISSION_DIM - len(slots)), dtype=torch.int32)


def mission_rows(tid, *params) -> torch.Tensor:
    """int32 [N, MISSION_DIM] per-env mission vectors: template id ``tid``
    (an int or int32[N]) and per-env parameters (int32[N] tensors), the
    unused slots zero."""
    n, device = params[0].shape[0], params[0].device
    if len(params) + 1 > MISSION_DIM:
        raise ValueError(f"a mission holds at most {MISSION_DIM - 1} parameters")
    out = torch.zeros((n, MISSION_DIM), dtype=torch.int32, device=device)
    out[:, 0] = torch.as_tensor(tid, device=device)
    for i, p in enumerate(params):
        out[:, 1 + i] = p
    return out


def _format_param(kind: str, value: int) -> str:
    if kind == PARAM_COLOR:
        return IDX_TO_COLOR[value]
    if kind == PARAM_TYPE:
        return IDX_TO_OBJECT[value]
    return str(value)


def mission_to_text(mission) -> str:
    """Render one mission vector to the reference's mission string."""
    m = [int(v) for v in mission]
    template, kinds = TEMPLATES[m[0]]
    return template.format(*(_format_param(k, m[1 + i]) for i, k in enumerate(kinds)))
