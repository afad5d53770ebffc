"""Counter-based PRNG on tensors: Threefry-2x32-20 and ``uniform_index``.

Counterpart of ``minigrid_tpu/ops/prng.py``.  Families that draw randomness
inside an episode (the Dynamic-Obstacles walk) or regenerate a level inside
the whole-rollout kernel (``covers_reset`` exts, ``ops/fused_ext.py``) use
the stream ``threefry2x32(seed, counter)`` with integer seeds, so the plain
version here, the CUDA kernel (``csrc/prng.cuh``) and the JAX package give
the same bits for the same seeds.

torch has no full uint32 arithmetic and its ``>>`` on int32 is arithmetic,
so the words are held in int64 lanes masked to 32 bits.  Outputs are int64
tensors with values in [0, 2^32); ``to_int32`` reinterprets them as int32.
"""

from __future__ import annotations

import torch

# Threefry-2x32 rotation schedule (Random123 reference implementation).
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA
_MASK = 0xFFFFFFFF


def as_u32(x) -> torch.Tensor:
    """An int, or an integer tensor of any width, as uint32 values in int64."""
    return torch.as_tensor(x).to(torch.int64) & _MASK


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values in int64 lanes -> int32 with the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds: key (k0, k1), counter (x0, x1) -> two
    uniform 32-bit words.  Inputs are ints or integer tensors (int32 words
    are taken by their bits) and broadcast together; outputs are int64
    tensors holding uint32 values."""
    ks0, ks1 = as_u32(k0), as_u32(k1)
    ks2 = ks0 ^ ks1 ^ _PARITY
    x0 = (as_u32(x0) + ks0) & _MASK
    x1 = (as_u32(x1) + ks1) & _MASK
    ks = (ks1, ks2, ks0)
    for block in range(5):
        rots = _ROTATIONS[:4] if block % 2 == 0 else _ROTATIONS[4:]
        for r in rots:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[block % 3]) & _MASK
        x1 = (x1 + ks[(block + 1) % 3] + block + 1) & _MASK
    return x0, x1


def uniform_index(bits: torch.Tensor, count) -> torch.Tensor:
    """A uniform word -> an index in [0, count): the top 24 bits times
    ``count``, shifted down by 24, in 64-bit arithmetic.

    The JAX package multiplies in int32 (``minigrid_tpu/ops/prng.py:67-68``),
    which wraps once ``count > 128`` and then yields negative indices; for
    ``count <= 128`` the two agree exactly, and beyond it this one stays
    uniform.  Returns int64."""
    u24 = as_u32(bits) >> 8
    return (u24 * torch.as_tensor(count).to(torch.int64)) >> 24


def draw_seeds(generator: torch.Generator | None, n: int, device) -> torch.Tensor:
    """Per-env counter-stream seeds: int32 [n, 2], all 32 bits uniform."""
    return torch.randint(-(2**31), 2**31, (n, 2), generator=generator, device=device, dtype=torch.int32)
