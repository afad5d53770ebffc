"""Structured mission encoding: int32[MISSION_DIM] vectors whose slot 0 is a
template id and whose other slots are template parameters.

The JAX package assigns template ids in the order its env modules register
them (``minigrid_tpu/core/mission.py:28-40``).  This package starts from the
JAX package's whole built-in table, in that order, so its ids stay the same:
"get to the green goal square" is id 2.  A family written outside the
package adds its own templates with ``register_mission``, which appends to
the same table; every reader of the table reads it live.  ``MissionSpace``
is the reference's host-side space of mission strings.
"""

from __future__ import annotations

from itertools import product

import numpy as np
import torch

from minigrid_tpu_torch.core.constants import IDX_TO_COLOR, IDX_TO_OBJECT
from minigrid_tpu_torch.core.state import MISSION_DIM

PARAM_COLOR = "color"
PARAM_TYPE = "type"
PARAM_INT = "int"

_C, _T = PARAM_COLOR, PARAM_TYPE

# (template, parameter kinds), indexed by template id: the 22 built-in
# templates, then those that ``register_mission`` appends.
TEMPLATES: list[tuple[str, tuple[str, ...]]] = [
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
]
_TEMPLATE_IDS = {t: i for i, t in enumerate(TEMPLATES)}


def register_mission(template: str, params: tuple[str, ...] = ()) -> int:
    """Register a mission template; returns its stable global id, the
    existing one for a template already in the table
    (``minigrid_tpu/core/mission.py:28-40``).

    ``template`` is a ``str.format`` string with positional slots, e.g.
    ``"go get a {0} {1}"`` with params ("color", "type").
    """
    key = (template, tuple(params))
    if key not in _TEMPLATE_IDS:
        _TEMPLATE_IDS[key] = len(TEMPLATES)
        TEMPLATES.append(key)
    return _TEMPLATE_IDS[key]


def num_templates() -> int:
    return len(TEMPLATES)


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


# -- Word tokens for the language wrappers -----------------------------------
# The reference's fixed Minigrid vocabulary (minigrid/wrappers.py:471-530):
# colors, objects, verbs and other words, as minigrid_tpu/core/mission.py:77-92.
MINIGRID_WORDS = (
    ["red", "green", "blue", "yellow", "purple", "grey"]
    + ["unseen", "empty", "wall", "floor", "box", "key", "ball", "door", "goal", "agent", "lava"]
    + ["pick", "avoid", "get", "find", "put", "use", "open", "go", "fetch", "reach", "unlock", "traverse"]
    + [
        "up", "the", "a", "at", ",", "square", "and", "then", "to", "of", "rooms", "near", "opening",
        "must", "you", "matching", "end", "hallway", "object", "from", "room", "maze",
    ]
)
WORD_TO_IDX = {w: i for i, w in enumerate(MINIGRID_WORDS)}
_SLOT_KINDS = {PARAM_COLOR: 0, PARAM_TYPE: 1, PARAM_INT: 2}


def _template_words(template: str) -> list[str | int]:
    """A template as vocabulary words and int parameter-slot markers; commas
    are words of their own (the reference's string_to_indices,
    minigrid/wrappers.py:532-544, spaces them out)."""
    out: list[str | int] = []
    for piece in template.replace(",", " , ").split():
        out.append(int(piece[1:-1]) if piece.startswith("{") and piece.endswith("}") else piece)
    return out


def build_token_tables(max_words: int = 50) -> dict[str, torch.Tensor]:
    """Tables for mission vector -> word indices, as CPU tensors:

    * ``tokens`` int32 [T, max_words]: word index + 1 per template word, 0
      padding, and -(slot + 1) where parameter slot ``slot`` goes;
    * ``slot_kind`` int32 [T, MISSION_DIM - 1]: 0 color, 1 type, 2 int;
    * ``color_words``, ``type_words``: word index + 1 of each color and
      object type (0 for a type outside the vocabulary).
    """
    tokens = torch.zeros((len(TEMPLATES), max_words), dtype=torch.int32)
    slot_kind = torch.zeros((len(TEMPLATES), MISSION_DIM - 1), dtype=torch.int32)
    for t, (template, kinds) in enumerate(TEMPLATES):
        for s, kind in enumerate(kinds):
            slot_kind[t, s] = _SLOT_KINDS[kind]
        for w, piece in enumerate(_template_words(template)):
            tokens[t, w] = -(piece + 1) if isinstance(piece, int) else WORD_TO_IDX[piece] + 1
    color_words = torch.tensor([WORD_TO_IDX[IDX_TO_COLOR[c]] + 1 for c in range(6)], dtype=torch.int32)
    type_words = torch.tensor([WORD_TO_IDX.get(IDX_TO_OBJECT[o], -1) + 1 for o in range(11)], dtype=torch.int32)
    return {"tokens": tokens, "slot_kind": slot_kind, "color_words": color_words, "type_words": type_words}


def mission_word_tokens(mission: torch.Tensor, tables: dict[str, torch.Tensor]) -> torch.Tensor:
    """int32 [N, max_words] word indices (+1, 0 padding) of mission vectors
    [N, M]: the reference's string_to_indices (minigrid/wrappers.py:546-550).
    Indices past a table's end are clamped to it, as JAX's gathers do."""
    tables = {k: v.to(mission.device) for k, v in tables.items()}
    tid = mission[:, 0].long().clamp(0, tables["tokens"].shape[0] - 1)
    toks = tables["tokens"][tid]
    for s in range(MISSION_DIM - 1):
        kind = tables["slot_kind"][tid, s]
        p = mission[:, 1 + s].long()
        word = torch.where(
            kind == 0, tables["color_words"][p.clamp(0, 5)], tables["type_words"][p.clamp(0, 10)]
        )
        toks = torch.where(toks == -(s + 1), word[:, None], toks)
    return toks


class MissionSpace:
    """Host-side space of templated mission strings: the reference's public
    ``MissionSpace`` API (minigrid/core/mission.py:14-199; the JAX package's
    ``minigrid_tpu/core/mission.py:164-235``).

    ``mission_func`` maps one value per placeholder list to a mission
    string; ``ordered_placeholders`` is a list of candidate-string lists (or
    None for a constant mission).  ``sample`` draws placeholder values
    uniformly from a numpy generator; ``contains`` tries every placeholder
    combination.
    """

    def __init__(self, mission_func, ordered_placeholders=None, seed=None):
        if ordered_placeholders is not None:
            assert len(ordered_placeholders) == mission_func.__code__.co_argcount, (
                "the number of placeholder lists must equal the number of mission_func parameters"
            )
            for placeholder_list in ordered_placeholders:
                assert len(placeholder_list) == len(set(placeholder_list)), f"duplicate placeholders in {placeholder_list}"
        self.mission_func = mission_func
        self.ordered_placeholders = ordered_placeholders
        self._rng = np.random.default_rng(seed)

    def seed(self, seed=None):
        self._rng = np.random.default_rng(seed)

    def sample(self) -> str:
        if self.ordered_placeholders is None:
            return self.mission_func()
        picks = [placeholders[self._rng.integers(0, len(placeholders))] for placeholders in self.ordered_placeholders]
        return self.mission_func(*picks)

    def contains(self, x) -> bool:
        """Whether ``x`` is a string this space produces."""
        if not isinstance(x, str):
            return False
        if self.ordered_placeholders is None:
            return x == self.mission_func()
        return any(self.mission_func(*combo) == x for combo in product(*self.ordered_placeholders))

    def __repr__(self):
        return f"MissionSpace({self.mission_func!r}, {self.ordered_placeholders!r})"

    def __eq__(self, other):
        if not isinstance(other, MissionSpace):
            return False
        if (self.ordered_placeholders is None) != (other.ordered_placeholders is None):
            return False
        if self.ordered_placeholders is None:
            return self.mission_func() == other.mission_func()
        if list(map(tuple, self.ordered_placeholders)) != list(map(tuple, other.ordered_placeholders)):
            return False
        probe = [p[0] for p in self.ordered_placeholders]
        return self.mission_func(*probe) == other.mission_func(*probe)
