"""Gathers over trees of tensors that share a leading axis.

Counterpart of ``minigrid_tpu/utils/tree_gather.py:63-97``.  The JAX package
packs every leaf into one int32 buffer so that a TPU gather runs once
(``tree_pack``/``tree_unpack``); on the GPU each leaf is indexed on its own,
so only the two functions its callers use are kept.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core.state import tree_map


def tree_take(tree, idx: torch.Tensor):
    """Every leaf of ``tree`` indexed by ``idx`` along its leading axis."""
    idx = idx.long()
    return tree_map(lambda a: a[idx], tree)


def compact_valid_indices(valid: torch.Tensor, total: int) -> torch.Tensor:
    """int64 [total]: the indices of the set entries of bool [N] ``valid``
    in order, wrapping around when fewer than ``total`` are set (and index
    0 repeated where none is)."""
    found = torch.nonzero(valid, as_tuple=True)[0]
    if found.numel() == 0:
        return torch.zeros(total, dtype=torch.int64, device=valid.device)
    return found[torch.arange(total, device=valid.device) % found.numel()]
