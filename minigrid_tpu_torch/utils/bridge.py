"""Carry environment state and network parameters between the JAX package
and this one, as numpy.

``state_from_numpy`` takes a JAX ``EnvState`` (or reset cache) whose leaves
were turned into numpy arrays, given as a mapping of field name to array,
and returns this package's ``EnvState`` on ``device``.  A family's
``extra`` state comes as a mapping of leaf name to array under ``"extra"``
(Dynamic-Obstacles: ``obstacles`` [N, n, 2], ``front_not_clear``,
``walk_seed`` [N, 2]), dtypes kept.  A structured leaf (BabyAI's
``"instr"``, a dataclass of arrays) comes as a dataclass or as a mapping of
its field names, and becomes the dataclass that the caller names for its
key in ``extra_types``.  ``rng``, which this package does not hold, is
ignored.  ``state_to_numpy`` is the inverse, with a dataclass leaf as a
mapping of its field names.

``params_from_flax`` turns the flax ``ActorCritic`` parameter tree (nested
dicts of numpy arrays: ``Dense_0..3`` with ``kernel [in, out]`` and
``bias``) into the ``state_dict`` of ``rl/model.ActorCritic``, which keeps
the same layout; ``params_to_flax`` is the inverse.  None of them imports
JAX.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from minigrid_tpu_torch.core.state import FIELDS, EnvState

_BOOL_FIELDS = ("terminated", "truncated")


def state_from_numpy(
    arrays: Mapping[str, np.ndarray], device=None, extra_types: Mapping[str, type] | None = None
) -> EnvState:
    """``EnvState`` from a mapping of field name to numpy array; a
    structured ``extra`` leaf becomes the dataclass ``extra_types`` names
    for its key."""
    missing = [f for f in FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"state is missing fields {missing}")
    out = {}
    for f in FIELDS:
        dtype = torch.bool if f in _BOOL_FIELDS else torch.int32
        out[f] = torch.from_numpy(np.array(arrays[f])).to(device=device, dtype=dtype)
    extra = arrays.get("extra")
    if extra is not None:
        kinds = extra_types or {}
        extra = {k: _leaf_from_numpy(v, device, kinds.get(k)) for k, v in extra.items()}
    return EnvState(**out, extra=extra)


def _leaf_from_numpy(value, device, kind: type | None):
    """An ``extra`` value: an array, or a dataclass (or mapping of its
    fields) that becomes a ``kind``."""
    if dataclasses.is_dataclass(value):
        value = {f.name: getattr(value, f.name) for f in dataclasses.fields(value)}
    if not isinstance(value, Mapping):
        return torch.from_numpy(np.array(value)).to(device)
    if kind is None:
        raise TypeError("a structured extra leaf needs its dataclass in extra_types")
    return kind(**{k: torch.from_numpy(np.array(v)).to(device) for k, v in value.items()})


def _leaf_to_numpy(value):
    if dataclasses.is_dataclass(value):
        return {f.name: getattr(value, f.name).cpu().numpy() for f in dataclasses.fields(value)}
    return value.cpu().numpy()


def state_to_numpy(state: EnvState) -> dict:
    """Mapping of field name to numpy array (int32, bool flags), with the
    ``"extra"`` mapping where the state has one."""
    out = {f: getattr(state, f).cpu().numpy() for f in FIELDS}
    if state.extra is not None:
        out["extra"] = {k: _leaf_to_numpy(v) for k, v in state.extra.items()}
    return out


def params_from_flax(tree: Mapping, device=None) -> dict[str, torch.Tensor]:
    """``state_dict`` (``"Dense_0.kernel"``, ...) of a flax parameter tree,
    with or without its top-level ``"params"`` key."""
    layers = tree["params"] if "params" in tree else tree
    return {
        f"{layer}.{name}": torch.from_numpy(np.array(value, dtype=np.float32)).to(device)
        for layer, leaves in layers.items()
        for name, value in leaves.items()
    }


def params_to_flax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The flax parameter tree ``{"params": {"Dense_0": {"kernel", "bias"}}}``
    of a ``state_dict``, as numpy arrays."""
    layers: dict[str, dict[str, np.ndarray]] = {}
    for key, value in state_dict.items():
        layer, name = key.split(".")
        layers.setdefault(layer, {})[name] = value.detach().cpu().numpy()
    return {"params": layers}
