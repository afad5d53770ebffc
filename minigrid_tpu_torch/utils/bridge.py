"""Carry environment state between the JAX package and this one, as numpy.

``state_from_numpy`` takes a JAX ``EnvState`` (or reset cache) whose leaves
were turned into numpy arrays, given as a mapping of field name to array,
and returns this package's ``EnvState`` on ``device``.  Fields this package
does not hold (``rng``; ``extra``, which fixed-start Empty does not use) are
ignored.  ``state_to_numpy`` is the inverse.  Neither imports JAX.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from minigrid_tpu_torch.core.state import FIELDS, EnvState

_BOOL_FIELDS = ("terminated", "truncated")


def state_from_numpy(arrays: Mapping[str, np.ndarray], device=None) -> EnvState:
    """``EnvState`` from a mapping of field name to numpy array."""
    missing = [f for f in FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"state is missing fields {missing}")
    out = {}
    for f in FIELDS:
        dtype = torch.bool if f in _BOOL_FIELDS else torch.int32
        out[f] = torch.from_numpy(np.array(arrays[f])).to(device=device, dtype=dtype)
    return EnvState(**out)


def state_to_numpy(state: EnvState) -> dict[str, np.ndarray]:
    """Mapping of field name to numpy array (int32, bool flags)."""
    return {f: getattr(state, f).cpu().numpy() for f in FIELDS}
