"""Fused one-hot embedding + first dense layer, forward and backward.

Port of ``minigrid_tpu/ops/embed_dense.py``.  ``embed_dense1(w1, b1, packed,
direction)`` is ``bf16(embed_obs_packed(packed, direction) @ bf16(w1)) +
bf16(b1)`` in bf16, differentiable in ``w1`` and ``b1``, without the one-hot
feature matrix ([M, 984] bf16) ever existing.  The CUDA kernels
(``csrc/embed_dense.cu``) replace the Pallas kernels ``_fwd_kernel`` and
``_bwd_kernel``; ``EmbedDense1`` is the ``torch.autograd.Function`` that
``jax.custom_vjp`` was.

Layouts are the JAX package's: ``w1 [V*V*20+4, H]`` f32, ``b1 [H]``,
``packed [M, V*V]`` int32, ``direction [M]`` int32, and ``dW1`` comes back as
``[V*V*20+4, H]``.  The TPU kernel's sublane padding (24 rows per cell, 8
for the direction) is not carried over.

``embed_dense1`` dispatches on the device of ``packed``: CUDA tensors
launch the kernels (or raise), CPU tensors run ``embed_dense1_reference``.
``KERNEL_LAUNCHES`` counts the launches of each direction.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from minigrid_tpu_torch.ops._build import load_library

# Launches of the forward and the backward kernel since import (or since a
# caller reset them).
KERNEL_LAUNCHES = {"fwd": 0, "bwd": 0}

_FWD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def embed_dense1_reference(w1, b1, packed, direction) -> torch.Tensor:
    """Plain PyTorch version, on any device: the one-hot features made
    explicit, a bf16 product, and autograd for the gradients."""
    from minigrid_tpu_torch.rl.model import embed_obs_packed

    x = embed_obs_packed(packed, direction)
    return x @ w1.to(torch.bfloat16) + b1.to(torch.bfloat16)


def embed_dense1(w1, b1, packed, direction) -> torch.Tensor:
    """bf16 [M, H] first-layer pre-activation of ``packed`` [M, V*V] and
    ``direction`` [M]: the kernels for CUDA tensors, the plain version for
    CPU tensors."""
    if packed.device.type == "cpu":
        return embed_dense1_reference(w1, b1, packed, direction)
    return EmbedDense1.apply(w1, b1, packed, direction)


class EmbedDense1(torch.autograd.Function):
    """Forward and backward through the CUDA kernels; the backward rebuilds
    the one-hots from ``packed`` instead of saving them."""

    @staticmethod
    def forward(ctx, w1, b1, packed, direction):
        ctx.save_for_backward(packed, direction)
        ctx.dtypes = (w1.dtype, b1.dtype)
        return _forward(w1, b1, packed, direction)

    @staticmethod
    def backward(ctx, dy):
        packed, direction = ctx.saved_tensors
        dw1, db1 = _backward(packed, direction, dy)
        return dw1.to(ctx.dtypes[0]), db1.to(ctx.dtypes[1]), None, None


def _require(cond: bool, message: str) -> None:
    if not cond:
        raise ValueError(f"embed_dense1 kernel: {message}")


def _check_inputs(packed, direction) -> tuple[int, int]:
    _require(packed.device.type == "cuda", f"packed on {packed.device}, need CUDA (or CPU for the plain version)")
    _require(packed.dim() == 2, f"packed must be [M, V*V], got {tuple(packed.shape)}")
    m, v2 = packed.shape
    _require(direction.shape == (m,), f"direction must be [{m}], got {tuple(direction.shape)}")
    _require(packed.dtype == torch.int32 and direction.dtype == torch.int32, "packed and direction must be int32")
    _require(direction.device == packed.device, "packed and direction on different devices")
    return m, v2


def hidden_ok(hidden: int) -> bool:
    """Whether both directions take this hidden width: a multiple of 32 or
    a power of two, from 4 to 512 (the forward's slabs of 64 columns, the
    last one ragged, a narrower width one slab padded to 8; the backward
    pads to whole slabs of 64, ``backward_width``)."""
    return 4 <= hidden <= 512 and (hidden % 32 == 0 or hidden & (hidden - 1) == 0)


# The backward kernel's slab: one warpgroup's 64 hidden columns.
BWD_MIN_WIDTH = 64
# Samples per backward chunk (``CHUNK`` of ``csrc/embed_dense.cu``).
BWD_CHUNK = 7296


def backward_width(hidden: int) -> int:
    """The hidden width the backward kernel runs at: ``hidden`` rounded up
    to whole slabs of 64, dy padded with zero columns (their gradients are
    dropped)."""
    return -(-hidden // BWD_MIN_WIDTH) * BWD_MIN_WIDTH


def backward_scratch_shape(m: int, v2: int, hidden: int) -> tuple[int, int, int]:
    """[chunks, V*V*20 + 5, width] f32: the backward's per-chunk partials of
    dW1 and db1 for ``m`` samples, the last chunk ragged."""
    return -(-m // BWD_CHUNK), v2 * 20 + 5, backward_width(hidden)


def _forward(w1, b1, packed, direction) -> torch.Tensor:
    m, v2 = _check_inputs(packed, direction)
    _require(w1.dim() == 2 and w1.shape[0] == v2 * 20 + 4, f"w1 must be [{v2 * 20 + 4}, H], got {tuple(w1.shape)}")
    hidden = w1.shape[1]
    _require(hidden_ok(hidden), f"hidden size {hidden} is not one the kernel takes")
    _require(b1.shape == (hidden,), f"b1 must be [{hidden}], got {tuple(b1.shape)}")
    _require(w1.device == packed.device and b1.device == packed.device, "w1, b1 and packed on different devices")
    _require(w1.is_floating_point() and b1.is_floating_point(), "w1 and b1 must be floating point")
    lib = load_library("embed_dense")
    slab, words_per_sample = _forward_shape(lib, v2, hidden)
    _require(slab > 0, f"a view of {v2} cells is wider than the forward takes")
    # The kernel rounds float32 weights to bf16 as it loads them; other
    # types are rounded here first (exact in float32 after that).
    w1f, b1f = (t.detach() if t.dtype == torch.float32 else t.detach().to(torch.bfloat16).float() for t in (w1, b1))
    w1f, b1f, pk, dr = (t.contiguous() for t in (w1f, b1f, packed, direction))
    if w1f.data_ptr() % 16:  # the kernel reads W1 16 bytes at a time
        w1f = w1f.clone()
    words = torch.empty((m, words_per_sample), dtype=torch.int32, device=packed.device)
    out = torch.empty((m, hidden), dtype=torch.bfloat16, device=packed.device)
    fn = lib.embed_dense1_fwd_launch
    fn.argtypes = _FWD_ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        err = fn(
            pk.data_ptr(), dr.data_ptr(), w1f.data_ptr(), b1f.data_ptr(), words.data_ptr(), out.data_ptr(),
            m, v2, hidden, stream,
        )
    if err != 0:
        raise RuntimeError(f"embed_dense1 forward kernel launch failed with CUDA error {err}")
    KERNEL_LAUNCHES["fwd"] += 1
    return out


@functools.cache
def _forward_shape(lib, v2: int, hidden: int) -> tuple[int, int]:
    """The forward's slab width (hidden columns of W1 a CTA holds,
    resident or, past v = 15, streamed through shared memory; 0 when a
    view of ``v2`` cells is wider than the forward takes) at width
    ``hidden``, and its one-hot words per sample (the scratch's width)."""
    for name in ("embed_dense1_fwd_slab_width", "embed_dense1_fwd_words"):
        getattr(lib, name).restype = ctypes.c_int
    lib.embed_dense1_fwd_slab_width.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.embed_dense1_fwd_words.argtypes = [ctypes.c_int]
    return lib.embed_dense1_fwd_slab_width(v2, hidden), lib.embed_dense1_fwd_words(v2)


def _backward(packed, direction, dy) -> tuple[torch.Tensor, torch.Tensor]:
    m, v2 = _check_inputs(packed, direction)
    _require(m >= 1, "the backward needs at least one sample")
    _require(dy.dim() == 2 and dy.shape[0] == m, f"dy must be [{m}, H], got {tuple(dy.shape)}")
    hidden = dy.shape[1]
    _require(hidden_ok(hidden), f"hidden size {hidden} is not one the kernel takes")
    _require(dy.dtype == torch.bfloat16, f"dy must be bf16, got {dy.dtype}")
    _require(dy.device == packed.device, "dy and packed on different devices")
    width = backward_width(hidden)
    pk, dr = packed.contiguous(), direction.contiguous()
    g = dy.contiguous() if width == hidden else torch.nn.functional.pad(dy, (0, width - hidden))
    lib = load_library("embed_dense")
    lib.embed_dense1_bwd_chunks.argtypes = [ctypes.c_int]
    lib.embed_dense1_bwd_chunks.restype = ctypes.c_int
    shape = backward_scratch_shape(m, v2, hidden)
    _require(lib.embed_dense1_bwd_chunks(m) == shape[0], "the source's chunk size is not BWD_CHUNK")
    part = torch.empty(shape, dtype=torch.float32, device=packed.device)
    dw1 = torch.empty((shape[1] - 1, width), dtype=torch.float32, device=packed.device)
    db1 = torch.empty((width,), dtype=torch.float32, device=packed.device)
    fn = lib.embed_dense1_bwd_launch
    fn.argtypes = _BWD_ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        err = fn(
            pk.data_ptr(), dr.data_ptr(), g.data_ptr(), part.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
            m, v2, width, stream,
        )
    if err != 0:
        raise RuntimeError(f"embed_dense1 backward kernel launch failed with CUDA error {err}")
    KERNEL_LAUNCHES["bwd"] += 1
    if width != hidden:
        return dw1[:, :hidden].contiguous(), db1[:hidden].contiguous()
    return dw1, db1
