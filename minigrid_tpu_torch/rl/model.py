"""Actor-critic network for Minigrid observations.

Counterpart of ``minigrid_tpu/rl/model.py``: the packed int32 [.., v*v] view
and the direction are embedded as one-hot planes (per view cell 11 type + 6
color + 3 state features, cells major, then 4 direction features) and fed
to an MLP with bf16 compute and f32 parameters.  The parameters keep flax's
layout (``Dense_i.kernel [in, out]``, ``Dense_i.bias``), so
``utils/bridge.params_from_flax`` gives both packages the same weights.

Rounding follows flax's ``nn.Dense(dtype=bfloat16)``: inputs, kernel and
bias are cast to bf16, the product accumulates in f32 and is rounded to
bf16, and the bias is added in bf16.  The two heads run in f32 on the bf16
activations.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from minigrid_tpu_torch.core.actions import NUM_ACTIONS
from minigrid_tpu_torch.core.constants import NUM_COLORS, NUM_OBJECTS
from minigrid_tpu_torch.core.state import resolve_device

PER_CELL = NUM_OBJECTS + NUM_COLORS + 3  # one-hot features per view cell
# flax's lecun_normal draws a normal truncated to +-2 standard deviations and
# divides the scale by this factor, the standard deviation of the unit
# normal truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978


def num_features(view_size: int) -> int:
    return view_size * view_size * PER_CELL + 4


def _onehot_feats(t, c, s, direction) -> torch.Tensor:
    """bf16 [.., v*v*20 + 4] one-hots of the type, color and state planes
    [.., v*v] (state clipped to [0, 2]) and of the direction [..]."""
    def onehot(x, k):
        return x[..., None] == torch.arange(k, dtype=x.dtype, device=x.device)

    feats = torch.cat(
        [onehot(t, NUM_OBJECTS), onehot(c, NUM_COLORS), onehot(s.clamp(0, 2), 3)], dim=-1
    ).flatten(-2)
    dir_oh = onehot(direction.to(torch.int32), 4)
    return torch.cat([feats, dir_oh], dim=-1).to(torch.bfloat16)


def embed_obs(image: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """uint8 [.., v, v, 3] + int32 [..] -> bf16 [.., F] one-hot features."""
    img = image.to(torch.int32).flatten(-3, -2)
    return _onehot_feats(img[..., 0], img[..., 1], img[..., 2], direction)


def embed_obs_packed(packed: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """int32 [.., v*v] packed view + int32 [..] -> bf16 [.., F] features,
    exactly those of ``embed_obs`` on the unpacked image."""
    p = packed.to(torch.int32)
    return _onehot_feats(p & 0xFF, (p >> 8) & 0xFF, (p >> 16) & 0xFF, direction)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel [in, out]``, ``bias [out]``, lecun-normal
    kernel (truncated normal, std 1/sqrt(in)) and zero bias."""

    def __init__(self, fan_in: int, fan_out: int, generator=None, device=None):
        super().__init__()
        device = resolve_device(generator, device)
        std = 1.0 / math.sqrt(fan_in) / _TRUNC_STD
        kernel = torch.empty(fan_in, fan_out, device=device)
        nn.init.trunc_normal_(kernel, 0.0, std, -2 * std, 2 * std, generator=generator)
        self.kernel = nn.Parameter(kernel)
        self.bias = nn.Parameter(torch.zeros(fan_out, device=device))

    def bf16(self, x: torch.Tensor) -> torch.Tensor:
        """bf16(bf16(x @ bf16(kernel)) + bf16(bias))."""
        return x.to(torch.bfloat16) @ self.kernel.to(torch.bfloat16) + self.bias.to(torch.bfloat16)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.float() @ self.kernel + self.bias


class ActorCritic(nn.Module):
    """MLP torso with policy and value heads; bf16 compute, f32 params.

    ``forward(image, direction, packed=False)`` takes the uint8 (v, v, 3)
    image, or with ``packed=True`` the packed int32 [.., v*v] view; both
    embed to the same features.  Returns (logits f32 [.., A], value f32 [..]).
    Parameters go on ``device``, else the generator's device, else CUDA.
    """

    def __init__(
        self,
        hidden: int = 256,
        num_actions: int = NUM_ACTIONS,
        view_size: int = 7,
        generator: torch.Generator | None = None,
        device=None,
    ):
        super().__init__()
        device = resolve_device(generator, device)
        self.hidden = int(hidden)
        self.num_actions = int(num_actions)
        self.view_size = int(view_size)
        self.Dense_0 = Dense(num_features(view_size), hidden, generator, device)
        self.Dense_1 = Dense(hidden, hidden, generator, device)
        self.Dense_2 = Dense(hidden, num_actions, generator, device)
        self.Dense_3 = Dense(hidden, 1, generator, device)

    def heads(self, x: torch.Tensor):
        """Dense_1 and the two f32 heads on the first layer's bf16 output
        (before its ReLU)."""
        x = torch.relu(self.Dense_1.bf16(torch.relu(x)))
        return self.Dense_2(x), self.Dense_3(x)[..., 0]

    def forward(self, image: torch.Tensor, direction: torch.Tensor, packed: bool = False):
        x = embed_obs_packed(image, direction) if packed else embed_obs(image, direction)
        return self.heads(self.Dense_0.bf16(x))


def apply_packed_fused(model: ActorCritic, packed: torch.Tensor, direction: torch.Tensor):
    """``model(packed, direction, packed=True)`` with the first layer run
    through the fused embed + dense-1 op (ops/embed_dense.py): the kernel on
    CUDA tensors, so the one-hot features never reach device memory.
    ``packed`` may carry leading batch dims; they are flattened for the op
    and restored on the outputs.  Agrees with ``model`` up to bf16 rounding.
    """
    from minigrid_tpu_torch.ops.embed_dense import embed_dense1

    lead = packed.shape[:-1]
    x = embed_dense1(
        model.Dense_0.kernel,
        model.Dense_0.bias,
        packed.reshape(-1, packed.shape[-1]),
        direction.reshape(-1),
    )
    logits, value = model.heads(x)
    return logits.reshape(lead + (logits.shape[-1],)), value.reshape(lead)
