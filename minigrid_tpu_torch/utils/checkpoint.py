"""Checkpoint / resume for env-state and learner trees.

Counterpart of ``minigrid_tpu/utils/checkpoint.py``.  Any ``EnvState``
batch, PPO ``TrainState`` or other tree of tensors round-trips through one
``.npz`` file whose entries are keyed by tree path in the spelling of JAX's
``jax.tree_util.keystr``: ``.grid``, ``.extra['instr'].gridm``,
``.opt_state.mu['Dense_0.kernel']``.  With the same spelling a batch of
states saved by either package loads in the other (JAX's files also carry
``.rng``, which this package's ``EnvState`` has not; ``load_npz`` reads
only the leaves its ``like`` asks for, as JAX's does).

A tree is a tensor, a Python int, a ``torch.Generator``, an
``nn.Module``, or a dict, tuple, NamedTuple or dataclass of trees, or
None.  A module is saved as its ``state_dict`` (under its parameter
names, ``.params['Dense_0.kernel']``) and a generator as ``get_state()``.
``save`` and ``load`` use ``<path>.npz``: JAX's ``save`` prefers orbax,
which the card's machine has not, and JAX's ``load`` reads ``<path>.npz``
first, so a file this package saves loads there too.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

def _children(tree: Any, path: str) -> list[tuple[str, Any]]:
    """(path, subtree) of each child of a container, in keystr spelling."""
    if isinstance(tree, dict):
        return [(f"{path}[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f"{path}.{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, tuple):
        return [(f"{path}[{i}]", t) for i, t in enumerate(tree)]
    if dataclasses.is_dataclass(tree):
        return [(f"{path}.{f.name}", getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    raise TypeError(f"checkpoint: {path or 'the tree'} is a {type(tree).__name__}, not a tree of tensors")


def _is_leaf(tree: Any) -> bool:
    return isinstance(tree, (torch.Tensor, torch.Generator, int))


def _walk(tree: Any, path: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) of every leaf of ``tree``."""
    if tree is None:
        return []
    if _is_leaf(tree):
        return [(path, tree)]
    if isinstance(tree, nn.Module):
        tree = dict(tree.state_dict())
    return [leaf for child_path, child in _children(tree, path) for leaf in _walk(child, child_path)]


def _host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy()
    return np.asarray(leaf)


def _restore(like: Any, path: str, arrays) -> Any:
    """``like`` with each leaf replaced by ``arrays[path]``, in the leaf's
    dtype and on its device."""
    if like is None:
        return None
    if _is_leaf(like):
        value = arrays[path]
        if isinstance(like, torch.Tensor):
            return torch.from_numpy(np.array(value)).to(dtype=like.dtype, device=like.device)
        if isinstance(like, torch.Generator):
            generator = torch.Generator(device=like.device)
            generator.set_state(torch.from_numpy(np.array(value, dtype=np.uint8)))
            return generator
        return type(like)(value.item())
    if isinstance(like, nn.Module):
        module = copy.deepcopy(like)
        module.load_state_dict(_restore(dict(like.state_dict()), path, arrays))
        return module
    values = [_restore(child, child_path, arrays) for child_path, child in _children(like, path)]
    if isinstance(like, dict):
        return dict(zip(sorted(like), values))
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*values)
    if isinstance(like, tuple):
        return tuple(values)
    return dataclasses.replace(like, **{f.name: v for f, v in zip(dataclasses.fields(like), values)})


def save_npz(path: str, tree: Any) -> None:
    """Write a tree of tensors to one ``.npz`` file (host-side copy)."""
    np.savez_compressed(path, **{p: _host(leaf) for p, leaf in _walk(tree)})


def load_npz(path: str, like: Any) -> Any:
    """Restore a tree saved by :func:`save_npz` (or by the JAX package's);
    ``like`` supplies the structure, each leaf's dtype and device."""
    with np.load(path) as z:
        missing = [p for p, _ in _walk(like) if p not in z.files]
        if missing:
            raise KeyError(f"checkpoint {path} missing leaves: {missing}")
        return _restore(like, "", z)


def save(path: str, tree: Any) -> None:
    """Checkpoint ``tree`` at ``<path>.npz``."""
    save_npz(path + ".npz", tree)


def load(path: str, like: Any) -> Any:
    """Restore a checkpoint written by :func:`save` (or by the JAX package's
    ``.npz`` fallback)."""
    return load_npz(path + ".npz", like)
