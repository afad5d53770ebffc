"""The port's CUDA kernel against its plain PyTorch version, on a GPU.

These tests need an NVIDIA GPU and ``nvcc``; they skip without them.  They
import no JAX, so they also run where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import minigrid_tpu_torch as mgt
from minigrid_tpu_torch.core.env import MiniGridEnv
from minigrid_tpu_torch.core.state import FIELDS
from minigrid_tpu_torch.ops import fused_rollout as fr
from minigrid_tpu_torch.parallel.vector import fused_eligible, rollout_random
from minigrid_tpu_torch.utils.bridge import state_from_numpy
from minigrid_tpu_torch.utils.synthetic import random_states

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _assert_same(got, want):
    for f in FIELDS:
        assert torch.equal(getattr(got[0], f), getattr(want[0], f)), f
    assert [int(x) for x in got[2:]] == [int(x) for x in want[2:]]
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-5)


@pytest.mark.parametrize("see_through", [False, True])
@pytest.mark.parametrize("compute_obs", [False, True])
def test_kernel_matches_plain_version_on_object_rich_states(device, see_through, compute_obs):
    rng = np.random.default_rng(5)
    n, steps, w, h = 2048, 48, 9, 7
    states = state_from_numpy(random_states(rng, (n,), w, h), device)
    cache = state_from_numpy(random_states(rng, (n, 2), w, h, fresh=True), device)
    actions = torch.from_numpy(rng.integers(0, 7, (steps, n), dtype=np.int32)).to(device)
    env = MiniGridEnv(w, h, max_steps=100, see_through_walls=see_through)
    before = fr.KERNEL_LAUNCHES
    got = fr.fused_rollout_core(env, states, cache, actions, compute_obs)
    torch.cuda.synchronize()
    assert fr.KERNEL_LAUNCHES == before + 1
    _assert_same(got, fr.fused_rollout_reference(env, states, cache, actions, compute_obs))


def test_rollout_random_takes_the_kernel_on_empty(device):
    env = mgt.make("MiniGrid-Empty-8x8-v0", max_steps=20)
    assert fused_eligible(env, device)
    gen = torch.Generator(device=device).manual_seed(1)
    _, states = env.reset(4096, gen, device)
    snapshot = gen.get_state()
    before = fr.KERNEL_LAUNCHES
    final, total_r, total_done, max_used = rollout_random(env, states, gen, 64)
    assert fr.KERNEL_LAUNCHES == before + 1
    gen.set_state(snapshot)
    actions = torch.randint(0, 7, (64, 4096), generator=gen, device=device, dtype=torch.int32)
    cache = env.batch_reset_cache(4096, 1, gen, device)
    want = fr.fused_rollout_reference(env, states, cache, actions, False)
    _assert_same((final, total_r, total_done, torch.zeros(()), max_used), want)


def test_wrapper_rejects_what_the_kernel_does_not_take(device):
    env = mgt.make("MiniGrid-Empty-8x8-v0", agent_view_size=5)
    _, states = env.reset(32, None, device)
    cache = env.batch_reset_cache(32, 1, None, device)
    actions = torch.zeros((4, 32), dtype=torch.int32, device=device)
    with pytest.raises(ValueError, match="view size 5"):
        fr.fused_rollout_core(env, states, cache, actions)
    env7 = mgt.make("MiniGrid-Empty-8x8-v0")
    with pytest.raises(ValueError, match="actions"):
        fr.fused_rollout_core(env7, states, cache, actions[:, :16])
