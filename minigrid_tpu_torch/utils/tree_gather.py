"""Gathers over trees of tensors that share a leading axis.

Counterpart of ``minigrid_tpu/utils/tree_gather.py:63-97``.  The JAX package
packs every leaf into one int32 buffer so that a TPU gather runs once
(``tree_pack``/``tree_unpack``); on the GPU each leaf is indexed on its own,
so only the function its callers use is kept.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core.state import tree_map


def tree_take(tree, idx: torch.Tensor):
    """Every leaf of ``tree`` indexed by ``idx`` along its leading axis."""
    idx = idx.long()
    return tree_map(lambda a: a[idx], tree)

