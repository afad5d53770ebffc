"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

These tests need an NVIDIA GPU and ``nvcc``; they skip without them.  They
import no JAX, so they also run where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import pytest
import torch

import minigrid_tpu_torch as mgt
from minigrid_tpu_torch import wrappers as wr
from minigrid_tpu_torch.core import obs as obs_lib
from minigrid_tpu_torch.core.env import MiniGridEnv
from minigrid_tpu_torch.core.sampling import randint
from minigrid_tpu_torch.core.constants import OBJ_WALL, cell_type
from minigrid_tpu_torch.core.state import FIELDS, tree_leaves
from minigrid_tpu_torch.envs.wfc import WFC_PRESETS
from minigrid_tpu_torch.envs.wfc import solver as wfc_solver
from minigrid_tpu_torch.envs.wfc import wfcenv
from minigrid_tpu_torch.envs.wfc.preprocess import WFC_PRESETS_ALL, build_tables
from minigrid_tpu_torch.ops import actor_rollout as ar
from minigrid_tpu_torch.ops import embed_dense as ed
from minigrid_tpu_torch.ops import fused_ext as fx
from minigrid_tpu_torch.ops import fused_rollout as fr
from minigrid_tpu_torch.ops import obs_packed as op
from minigrid_tpu_torch.ops import wfc_solve as wk
from minigrid_tpu_torch.ops import _build
from minigrid_tpu_torch.ops._build import load_library
from minigrid_tpu_torch.parallel.reset_budget import learner_resets
from minigrid_tpu_torch.parallel.vector import fused_eligible, rollout_random
from minigrid_tpu_torch.rl.impala import IMPALAConfig, make_impala
from minigrid_tpu_torch.rl.model import ActorCritic
from minigrid_tpu_torch.rl.ppo import PPOConfig, make_ppo
from minigrid_tpu_torch.rl.rollout import collect_trajectory
from minigrid_tpu_torch.utils import golden
from minigrid_tpu_torch.utils.bridge import state_from_numpy
from minigrid_tpu_torch.utils.synthetic import random_states
from test_torch_authoring import (
    TARGET_HEADER,
    TURNS_HEADER,
    TargetBallEnv,
    TurnsEnv,
    write_header,
    write_target_header,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _launches():
    """Launches so far of the actor kernel, the observation kernel and the
    embed + dense-1 forward and backward."""
    return ar.KERNEL_LAUNCHES, op.KERNEL_LAUNCHES, ed.KERNEL_LAUNCHES["fwd"], ed.KERNEL_LAUNCHES["bwd"]


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
    # States of view 7 (a reset at view 33 would stop in the observation
    # kernel, which takes views up to 31 too).
    env7 = mgt.make("MiniGrid-Empty-8x8-v0")
    _, states = env7.reset(32, None, device)
    cache = env7.batch_reset_cache(32, 1, None, device)
    actions = torch.zeros((4, 32), dtype=torch.int32, device=device)
    with pytest.raises(ValueError, match="view size 33"):
        fr.fused_rollout_core(mgt.make("MiniGrid-Empty-8x8-v0", agent_view_size=33), states, cache, actions)
    with pytest.raises(ValueError, match="actions"):
        fr.fused_rollout_core(env7, states, cache, actions[:, :16])


COUNTER_IDS = ["MiniGrid-Empty-Random-5x5-v0", "MiniGrid-LavaCrossingS9N2-v0", "MiniGrid-Dynamic-Obstacles-8x8-v0"]


@pytest.mark.parametrize("compute_obs", [False, True])
@pytest.mark.parametrize("env_id", COUNTER_IDS)
def test_ext_kernel_matches_plain_version(device, env_id, compute_obs):
    # The family hooks, the extra scalars and the in-kernel counter reset;
    # a short max_steps adds truncations to the terminations.
    env = mgt.make(env_id, max_steps=24)
    n, steps = 4096, 64
    gen = torch.Generator(device=device).manual_seed(2)
    _, states = env.reset(n, gen)
    actions = torch.randint(0, env.num_actions, (steps, n), generator=gen, device=device, dtype=torch.int32)
    seeds = torch.randint(-(2**31), 2**31, (n, 2), generator=gen, device=device, dtype=torch.int32)
    before = fr.KERNEL_LAUNCHES
    got = fr.fused_rollout_core(env, states, None, actions, compute_obs, seeds)
    torch.cuda.synchronize()
    assert fr.KERNEL_LAUNCHES == before + 1
    want = fr.fused_rollout_reference(env, states, None, actions, compute_obs, seeds)
    _assert_same(got, want)
    assert (got[0].extra is None) == (want[0].extra is None)
    for k, v in (want[0].extra or {}).items():
        assert torch.equal(got[0].extra[k], v), k
    assert int(got[2]) > n and int(got[4]) == 0


def test_ext_wrappers_reject_what_their_kernels_do_not_take(device):
    env = mgt.make("MiniGrid-Dynamic-Obstacles-8x8-v0")
    gen = torch.Generator(device=device).manual_seed(0)
    _, states = env.reset(64, gen)
    actions = torch.zeros((4, 64), dtype=torch.int32, device=device)
    seeds = torch.zeros((64, 2), dtype=torch.int32, device=device)
    with pytest.raises(ValueError, match="reset_seeds"):
        fr.fused_rollout_core(env, states, None, actions, True, seeds[:32])
    with pytest.raises(ValueError, match="not a cache"):
        fr.fused_rollout_core(env, states, env.batch_reset_cache(64, 1, gen), actions, True, seeds)
    big = mgt.make("MiniGrid-Dynamic-Obstacles-16x16-v0", n_obstacles=9)
    assert big.n_obstacles == 9 and not fused_eligible(big, device)
    _, big_states = big.reset(64, gen)
    with pytest.raises(ValueError, match="no compiled CUDA twin"):
        fr.fused_rollout_core(big, big_states, None, actions, True, seeds)
    # The actor kernel runs Dynamic-Obstacles-8x8, through its wrapper and
    # the learner, and refuses what the rollout kernel refuses.
    model = ActorCritic(64, env.num_actions, generator=gen)
    weights = ar.repack_actor_params(model)
    noise = ar.draw_bits(gen, (4, env.num_actions, 64), device)
    before = ar.KERNEL_LAUNCHES
    final, traj = ar.fused_actor_rollout_core(env, weights, states, None, noise, seeds)
    torch.cuda.synchronize()
    assert ar.KERNEL_LAUNCHES == before + 1 and traj["obs"].shape == (4, 64, 49)
    assert set(final.extra) == set(states.extra)
    with pytest.raises(ValueError, match="reset_seeds"):
        ar.fused_actor_rollout_core(env, weights, states, None, noise)
    init_fn, train_step = make_ppo(env, PPOConfig(rollout_steps=4, num_minibatches=1), hidden=64)
    _, metrics = train_step(init_fn(gen, 64))
    assert ar.KERNEL_LAUNCHES == before + 2 and bool(torch.isfinite(metrics["pg_loss"]))
    with pytest.raises(ValueError, match="no compiled CUDA twin"):
        ar.fused_actor_rollout_core(big, weights, big_states, None, noise, seeds)
    init_fn, train_step = make_ppo(big, PPOConfig(rollout_steps=4, num_minibatches=1), hidden=64)
    with pytest.raises(ValueError, match="no compiled CUDA twin"):
        train_step(init_fn(gen, 64))


def _embed_inputs(device, m, hidden, seed):
    rng = np.random.default_rng(seed)
    env = MiniGridEnv(9, 7, max_steps=100)
    states = state_from_numpy(random_states(rng, (m,), 9, 7), device)
    packed = env.observation_packed(states)
    w1 = torch.from_numpy(rng.normal(0, 0.03, (49 * 20 + 4, hidden)).astype(np.float32)).to(device)
    b1 = torch.from_numpy(rng.normal(0, 0.1, hidden).astype(np.float32)).to(device)
    dy = torch.from_numpy(rng.normal(0, 1e-2, (m, hidden)).astype(np.float32)).to(device, torch.bfloat16)
    return packed, states.agent_dir, w1, b1, dy


@pytest.mark.parametrize("hidden", [64, 256])
def test_embed_dense_kernels_match_plain_version(device, hidden):
    m = 5000  # a ragged last backward chunk
    packed, direction, w1, b1, dy = _embed_inputs(device, m, hidden, 3)
    before = dict(ed.KERNEL_LAUNCHES)
    w1g, b1g = w1.clone().requires_grad_(), b1.clone().requires_grad_()
    out = ed.embed_dense1(w1g, b1g, packed, direction)
    dw, db = torch.autograd.grad(out, (w1g, b1g), dy)
    torch.cuda.synchronize()
    assert ed.KERNEL_LAUNCHES == {"fwd": before["fwd"] + 1, "bwd": before["bwd"] + 1}
    w1p, b1p = w1.clone().requires_grad_(), b1.clone().requires_grad_()
    want = ed.embed_dense1_reference(w1p, b1p, packed, direction)
    assert out.dtype == torch.bfloat16 and out.shape == (m, hidden)
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=2e-2)
    for got, ref in zip((dw, db), torch.autograd.grad(want, (w1p, b1p), dy)):
        scale = max(1.0, float(ref.abs().max()))
        torch.testing.assert_close(got, ref.float(), rtol=0, atol=2e-2 * scale)
    dw2, db2 = ed._backward(packed, direction, dy)
    assert torch.equal(dw2, dw) and torch.equal(db2, db)  # deterministic


@pytest.mark.parametrize("hidden", [16, 64, 128, 256, 512])
@pytest.mark.parametrize("m", [1, 63, 65, 5000, 8192])
def test_embed_forward_matches_plain_version_and_repeats(device, m, hidden):
    packed, direction, w1, b1, _ = _embed_inputs(device, m, hidden, 5)
    before = ed.KERNEL_LAUNCHES["fwd"]
    out = ed.embed_dense1(w1, b1, packed, direction)
    again = ed.embed_dense1(w1, b1, packed, direction)
    torch.cuda.synchronize()
    assert ed.KERNEL_LAUNCHES["fwd"] == before + 2
    want = ed.embed_dense1_reference(w1, b1, packed, direction)
    assert out.dtype == torch.bfloat16 and out.shape == (m, hidden)
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=2e-2)
    assert torch.equal(out, again)  # bit-identical twice


# Resident slabs of 64, 32 and 8 columns at v = 3, 9 and 15; past 15 the
# slab is streamed through shared memory.
@pytest.mark.parametrize("view_size", [3, 9, 15, 17, 19, 31])
def test_embed_forward_takes_other_views(device, view_size):
    rng = np.random.default_rng(view_size)
    m, v2, hidden = 1000, view_size * view_size, 64
    fields = [rng.integers(0, hi, (m, v2)) for hi in (13, 8, 4)]  # some types and colors out of range
    packed = torch.from_numpy((fields[0] | fields[1] << 8 | fields[2] << 16).astype(np.int32)).to(device)
    direction = torch.from_numpy(rng.integers(-1, 6, m).astype(np.int32)).to(device)
    # Past v = 15 W1's spread shrinks as 1/v, so that the sums spread as at
    # v = 15 and one bf16 rounding of the output stays under the tolerance.
    scale = 0.03 * min(1.0, 15 / view_size)
    w1 = torch.from_numpy(rng.normal(0, scale, (v2 * 20 + 4, hidden)).astype(np.float32)).to(device)
    b1 = torch.from_numpy(rng.normal(0, 0.1, hidden).astype(np.float32)).to(device)
    streamed = load_library("embed_dense").embed_dense1_fwd_streamed
    streamed.argtypes, streamed.restype = [ctypes.c_int] * 2, ctypes.c_int
    assert streamed(v2, hidden) == (view_size >= 17)
    out = ed.embed_dense1(w1, b1, packed, direction)
    want = ed.embed_dense1_reference(w1, b1, packed, direction)
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=2e-2)
    assert torch.equal(out, ed.embed_dense1(w1, b1, packed, direction))  # bit-identical twice


@pytest.mark.parametrize("hidden", [48, 1024])
def test_embed_forward_raises_on_widths_it_does_not_take(device, hidden):
    packed, direction, _, _, _ = _embed_inputs(device, 64, 64, 1)
    w1 = torch.zeros(49 * 20 + 4, hidden, device=device)
    before = ed.KERNEL_LAUNCHES["fwd"]
    with pytest.raises(ValueError, match=f"hidden size {hidden}"):
        ed.embed_dense1(w1, torch.zeros(hidden, device=device), packed, direction)
    assert ed.KERNEL_LAUNCHES["fwd"] == before


def _actor_case(device, kind, n=2048, t=16, hidden=64, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    if kind == "empty5x5":
        env = mgt.make("MiniGrid-Empty-5x5-v0", max_steps=8)
        _, states = env.reset(n, gen, device)
        cache = env.batch_reset_cache(n, 2, gen, device)
    else:
        rng = np.random.default_rng(seed)
        env = MiniGridEnv(9, 7, max_steps=100)
        states = state_from_numpy(random_states(rng, (n,), 9, 7), device)
        cache = state_from_numpy(random_states(rng, (n, 2), 9, 7, fresh=True), device)
    model = ActorCritic(hidden, env.num_actions, generator=gen, device=device)
    with torch.no_grad():  # nonzero biases: init leaves them 0
        for i in range(4):
            bias = getattr(model, f"Dense_{i}").bias
            bias.copy_(0.1 * torch.randn(bias.shape, generator=gen, device=device))
    weights = ar.repack_actor_params(model)
    noise = ar.draw_bits(gen, (t, env.num_actions, n), device)
    return env, weights, states, cache, noise


@pytest.mark.parametrize("kind", ["empty5x5", "synthetic"])
def test_actor_kernel_meets_the_contracts(device, kind):
    env, weights, states, cache, noise = _actor_case(device, kind)
    before = ar.KERNEL_LAUNCHES
    final, traj = ar.fused_actor_rollout_core(env, weights, states, cache, noise)
    torch.cuda.synchronize()
    assert ar.KERNEL_LAUNCHES == before + 1
    assert int(traj["done"].sum()) > 0
    ar.check_trajectory(env, weights, states, cache, noise, final, traj, atol=ar.PLAIN_ATOL)


@pytest.mark.parametrize(
    "env_id", ["MiniGrid-Empty-8x8-v0", "MiniGrid-Dynamic-Obstacles-8x8-v0", "MiniGrid-DoorKey-8x8-v0"]
)
@pytest.mark.parametrize("learner", ["ppo", "impala"])
def test_train_step_goes_through_the_kernels(device, learner, env_id):
    env = mgt.make(env_id)
    if learner == "ppo":
        # The actor kernel, the observation kernel for the bootstrap value,
        # then per minibatch one embed + dense-1 forward and backward, and
        # one forward for GAE's bootstrap value.
        init_fn, train_step = make_ppo(env, PPOConfig(rollout_steps=16, num_minibatches=2), hidden=64)
        want = (1, 1, 3, 2)
    else:
        # Per minibatch two forwards (its slice and its bootstrap) and one
        # backward.
        init_fn, train_step = make_impala(env, IMPALAConfig(rollout_steps=16, num_minibatches=2), hidden=64)
        want = (1, 1, 4, 2)
    state = init_fn(torch.Generator(device=device).manual_seed(0), 1024)
    before = _launches()
    state, metrics = train_step(state)
    torch.cuda.synchronize()
    after = _launches()
    assert tuple(a - b for a, b in zip(after, before)) == want
    assert all(bool(torch.isfinite(metrics[k])) for k in ("pg_loss", "value_loss", "entropy"))
    assert state.env_states.grid.device.type == "cuda"


@pytest.mark.parametrize("env_id", COUNTER_IDS)
def test_actor_kernel_runs_the_counter_reset_families(device, env_id):
    # The ext hooks, the extra scalars and the in-kernel counter reset, with
    # the policy inside; a short max_steps adds truncations.
    env = mgt.make(env_id, max_steps=24)
    n, t = 4096, 64
    gen = torch.Generator(device=device).manual_seed(3)
    _, states = env.reset(n, gen)
    model = ActorCritic(64, env.num_actions, generator=gen)
    with torch.no_grad():  # nonzero biases: init leaves them 0
        for i in range(4):
            bias = getattr(model, f"Dense_{i}").bias
            bias.copy_(0.1 * torch.randn(bias.shape, generator=gen, device=device))
    weights = ar.repack_actor_params(model)
    seeds = torch.randint(-(2**31), 2**31, (n, 2), generator=gen, device=device, dtype=torch.int32)
    noise = ar.draw_bits(gen, (t, env.num_actions, n), device)
    before = ar.KERNEL_LAUNCHES
    final, traj = ar.fused_actor_rollout_core(env, weights, states, None, noise, seeds)
    torch.cuda.synchronize()
    assert ar.KERNEL_LAUNCHES == before + 1
    assert int(traj["done"].sum()) > n
    ar.check_trajectory(env, weights, states, None, noise, final, traj, ar.PLAIN_ATOL, reset_seeds=seeds)
    if "Dynamic" in env_id:  # the remap and the collision penalty ran
        assert int((traj["action"] >= 3).sum()) > 0 and float(traj["reward"].min()) == -1.0


WFC_IDS = [f"MiniGrid-WFC-{preset}-v0" for preset in sorted(WFC_PRESETS)]
CACHE_IDS = [
    "MiniGrid-DoorKey-8x8-v0",
    "MiniGrid-FourRooms-v0",
    "MiniGrid-GoToObject-8x8-N2-v0",
    "MiniGrid-GoToDoor-8x8-v0",
    "MiniGrid-Fetch-8x8-N3-v0",
    *WFC_IDS,
]


def _biased_actor(env, gen, device, hidden=64):
    """The actor's kernel weights with nonzero biases (init leaves them 0)."""
    model = ActorCritic(hidden, env.num_actions, generator=gen, device=device)
    with torch.no_grad():
        for i in range(4):
            bias = getattr(model, f"Dense_{i}").bias
            bias.copy_(0.1 * torch.randn(bias.shape, generator=gen, device=device))
    return ar.repack_actor_params(model)


@pytest.mark.parametrize("compute_obs", [False, True])
@pytest.mark.parametrize("env_id", CACHE_IDS)
def test_cache_kernel_matches_plain_version(device, env_id, compute_obs):
    # Levels with objects from the family's generator, and a cached ext's
    # extra scalars blended from the cache at every reset; a short max_steps
    # adds truncations, and the GoTo families run past R = 3 (the last slot
    # replays, in both versions).
    env = mgt.make(env_id, max_steps=24)
    n, steps = 4096, 64
    gen = torch.Generator(device=device).manual_seed(4)
    _, states = env.reset(n, gen)
    cache = env.batch_reset_cache(n, 3, gen)
    actions = torch.randint(0, env.num_actions, (steps, n), generator=gen, device=device, dtype=torch.int32)
    before = fr.KERNEL_LAUNCHES
    got = fr.fused_rollout_core(env, states, cache, actions, compute_obs)
    torch.cuda.synchronize()
    assert fr.KERNEL_LAUNCHES == before + 1
    want = fr.fused_rollout_reference(env, states, cache, actions, compute_obs)
    _assert_same(got, want)
    assert (got[0].extra is None) == (env.fused_ext is None)
    for k, v in (want[0].extra or {}).items():
        assert torch.equal(got[0].extra[k], v), k
    assert int(got[2]) >= n and int(got[4]) >= 1


@pytest.mark.parametrize(
    "env_id", ["MiniGrid-DoorKey-8x8-v0", "MiniGrid-GoToDoor-8x8-v0", "MiniGrid-Fetch-8x8-N3-v0", *WFC_IDS]
)
def test_actor_kernel_runs_the_cache_families(device, env_id):
    env = mgt.make(env_id, max_steps=24)
    n, t = 4096, 64
    gen = torch.Generator(device=device).manual_seed(5)
    _, states = env.reset(n, gen)
    weights = _biased_actor(env, gen, device)
    cache = env.batch_reset_cache(n, 3, gen)
    noise = ar.draw_bits(gen, (t, env.num_actions, n), device)
    before = ar.KERNEL_LAUNCHES
    final, traj = ar.fused_actor_rollout_core(env, weights, states, cache, noise)
    torch.cuda.synchronize()
    assert ar.KERNEL_LAUNCHES == before + 1
    assert int(traj["done"].sum()) >= n
    ar.check_trajectory(env, weights, states, cache, noise, final, traj, ar.PLAIN_ATOL)


class _PlanesExt(fx.CachedExt):
    """An ext with one extra plane per env, as BabyAI's has, and no compiled
    twin."""

    n_planes = 1
    kernel_id = None


def test_cached_ext_wrappers_reject_what_their_kernels_do_not_take(device):
    env = mgt.make("MiniGrid-GoToDoor-8x8-v0")
    gen = torch.Generator(device=device).manual_seed(6)
    _, states = env.reset(64, gen)
    cache = env.batch_reset_cache(64, 2, gen)
    actions = torch.zeros((4, 64), dtype=torch.int32, device=device)
    seeds = torch.zeros((64, 2), dtype=torch.int32, device=device)
    weights = _biased_actor(env, gen, device)
    noise = ar.draw_bits(gen, (4, env.num_actions, 64), device)
    planes = mgt.make("MiniGrid-GoToDoor-8x8-v0")
    planes.fused_ext = _PlanesExt()
    for run in (
        lambda e, c, s=None: fr.fused_rollout_core(e, states, c, actions, True, s),
        lambda e, c, s=None: ar.fused_actor_rollout_core(e, weights, states, c, noise, s),
    ):
        with pytest.raises(ValueError, match="must both carry them"):
            run(env, cache.replace(extra=None))
        with pytest.raises(ValueError, match="takes no reset_seeds"):
            run(env, cache, seeds)
        with pytest.raises(ValueError, match="P planes"):
            run(planes, cache)


# BabyAI's verifier (K=8 scalars, P=2 planes): GoToLocal's 8x8 room and
# GoTo's 22x22 maze of 3x3 rooms, with the env's own max_steps.
BABYAI_IDS = ["BabyAI-GoToLocal-v0", "BabyAI-GoTo-v0", "BabyAI-BossLevel-v0"]


def _assert_extra_same(got, want):
    leaves = tree_leaves(want)
    assert [k for k, _ in tree_leaves(got)] == [k for k, _ in leaves]
    for (k, a), (_, b) in zip(tree_leaves(got), leaves):
        assert a.dtype == b.dtype and torch.equal(a, b), k


@pytest.mark.parametrize("compute_obs", [False, True])
@pytest.mark.parametrize("env_id", BABYAI_IDS)
def test_babyai_kernel_matches_plain_version(device, env_id, compute_obs):
    # 4096 envs x 32 steps from the level's generator; R = 3 is passed on
    # GoToLocal (the last slot replays, in both versions), and both planes
    # come back bit for bit.
    env = mgt.make(env_id)
    n, steps = 4096, 32
    gen = torch.Generator(device=device).manual_seed(7)
    _, states = env.reset(n, gen)
    cache = env.batch_reset_cache(n, 3, gen)
    actions = torch.randint(0, env.num_actions, (steps, n), generator=gen, device=device, dtype=torch.int32)
    before = fr.KERNEL_LAUNCHES
    got = fr.fused_rollout_core(env, states, cache, actions, compute_obs)
    torch.cuda.synchronize()
    assert fr.KERNEL_LAUNCHES == before + 1
    want = fr.fused_rollout_reference(env, states, cache, actions, compute_obs)
    _assert_same(got, want)
    _assert_extra_same(got[0].extra, want[0].extra)
    assert int(got[2]) > 0


@pytest.mark.parametrize("env_id", BABYAI_IDS)
def test_actor_kernel_runs_babyai(device, env_id):
    env = mgt.make(env_id)
    n, t = 4096, 32
    gen = torch.Generator(device=device).manual_seed(8)
    _, states = env.reset(n, gen)
    weights = _biased_actor(env, gen, device)
    cache = env.batch_reset_cache(n, 3, gen)
    noise = ar.draw_bits(gen, (t, env.num_actions, n), device)
    before = ar.KERNEL_LAUNCHES
    final, traj = ar.fused_actor_rollout_core(env, weights, states, cache, noise)
    torch.cuda.synchronize()
    assert ar.KERNEL_LAUNCHES == before + 1
    assert int(traj["done"].sum()) > 0
    ar.check_trajectory(env, weights, states, cache, noise, final, traj, ar.PLAIN_ATOL)


# K1's whole-warp resets on the state and cache where they lie: tail warps,
# lanes resetting at spread steps and all at once, R = 1 and 137, every
# compiled ext; bit for bit, the reward total to rtol 1e-6.
K1_CASES = {
    # env id, N, steps, R, max_steps, ages: "fresh", "spread" or "last" (every lane ends at step 1)
    "doorkey-n1": ("MiniGrid-DoorKey-8x8-v0", 1, 64, 3, 24, "spread"),
    "doorkey-n31": ("MiniGrid-DoorKey-8x8-v0", 31, 64, 3, 24, "spread"),
    "doorkey-n33": ("MiniGrid-DoorKey-8x8-v0", 33, 64, 3, 24, "spread"),
    "doorkey-n4127": ("MiniGrid-DoorKey-8x8-v0", 4127, 64, 3, 24, "spread"),
    "empty-all-at-once": ("MiniGrid-Empty-8x8-v0", 4096, 32, 2, 16, "last"),
    "empty-r1": ("MiniGrid-Empty-8x8-v0", 4096, 64, 1, 12, "spread"),
    "fourrooms": ("MiniGrid-FourRooms-v0", 2048, 48, 3, 20, "spread"),
    "gotoobject-r137": ("MiniGrid-GoToObject-8x8-N2-v0", 1024, 256, 137, None, "spread"),
    "gotodoor": ("MiniGrid-GoToDoor-8x8-v0", 4096, 64, 3, 24, "spread"),
    "fetch": ("MiniGrid-Fetch-8x8-N3-v0", 4096, 64, 3, 24, "spread"),
    "gotolocal": ("BabyAI-GoToLocal-v0", 4096, 64, 4, 24, "spread"),
    "goto": ("BabyAI-GoTo-v0", 1024, 64, 3, 24, "spread"),
    "empty-random": ("MiniGrid-Empty-Random-5x5-v0", 4127, 64, 0, 16, "spread"),
    "crossing": ("MiniGrid-LavaCrossingS9N2-v0", 4096, 64, 0, 24, "spread"),
    "dynamic-obstacles": ("MiniGrid-Dynamic-Obstacles-8x8-v0", 4127, 64, 0, 24, "fresh"),
}


def _k1_inputs(device, name, seed=11):
    env_id, n, steps, r, max_steps, ages = K1_CASES[name]
    env = mgt.make(env_id) if max_steps is None else mgt.make(env_id, max_steps=max_steps)
    gen = torch.Generator(device=device).manual_seed(seed)
    _, states = env.reset(n, gen)
    if ages == "spread":
        states = states.replace(step_count=randint(gen, n, 0, states.max_steps))
    elif ages == "last":
        states = states.replace(step_count=states.max_steps - 1)
    actions = torch.randint(0, env.num_actions, (steps, n), generator=gen, device=device, dtype=torch.int32)
    if fr.counter_reset(env):
        seeds = torch.randint(-(2**31), 2**31, (n, 2), generator=gen, device=device, dtype=torch.int32)
        return env, states, None, actions, seeds
    return env, states, env.batch_reset_cache(n, r, gen), actions, None


@pytest.mark.parametrize("compute_obs", [False, True])
@pytest.mark.parametrize("name", list(K1_CASES))
def test_k1_matches_plain_version_bit_for_bit(device, name, compute_obs):
    env, states, cache, actions, seeds = _k1_inputs(device, name)
    n = states.step_count.shape[0]
    before = fr.KERNEL_LAUNCHES
    got = fr.fused_rollout_core(env, states, cache, actions, compute_obs, seeds)
    torch.cuda.synchronize()
    assert fr.KERNEL_LAUNCHES == before + 1
    want = fr.fused_rollout_reference(env, states, cache, actions, compute_obs, seeds)
    for f in FIELDS:
        assert torch.equal(getattr(got[0], f), getattr(want[0], f)), f
    assert (got[0].extra is None) == (want[0].extra is None)
    if want[0].extra is not None:
        _assert_extra_same(got[0].extra, want[0].extra)
    assert [int(x) for x in got[2:]] == [int(x) for x in want[2:]]
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-6)
    if K1_CASES[name][5] == "last":
        assert int(got[2]) >= n  # every lane ended its episode at the first step
    assert int(got[2]) > 0 and (cache is None or int(got[4]) >= 1)


def test_k1_allocates_no_env_minor_cache(device):
    # The reset cache is read where it lies: what a call allocates stays
    # below one [N, R, W*H] plane of it (the old layout's permuted copy).
    env, states, cache, actions, _ = _k1_inputs(device, "gotoobject-r137")
    fr.fused_rollout_core(env, states, cache, actions, False)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fr.fused_rollout_core(env, states, cache, actions, True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert int(out[2]) > 0 and peak < cache.grid.nbytes, (peak, cache.grid.nbytes)


def test_new_wrappers_reject_what_their_kernels_do_not_take(device):
    packed, direction, w1, b1, dy = _embed_inputs(device, 64, 64, 1)
    with pytest.raises(ValueError, match="need CUDA"):
        ed._forward(w1.cpu(), b1.cpu(), packed.cpu(), direction.cpu())
    with pytest.raises(ValueError, match="int32"):
        ed._forward(w1, b1, packed.long(), direction)
    with pytest.raises(ValueError, match="w1 must be"):
        ed._forward(w1[:-1], b1, packed, direction)
    with pytest.raises(ValueError, match="hidden size 1000"):
        ed._forward(torch.zeros(984, 1000, device=device), torch.zeros(1000, device=device), packed, direction)
    with pytest.raises(ValueError, match="bf16"):
        ed._backward(packed, direction, dy.float())

    env, weights, states, cache, noise = _actor_case(device, "empty5x5", n=64, t=2)
    with pytest.raises(ValueError, match="noise must be"):
        ar.fused_actor_rollout_core(env, weights, states, cache, noise[:, :3])
    with pytest.raises(ValueError, match="w1 must be"):
        ar.fused_actor_rollout_core(env, weights._replace(w1=weights.w1.float()), states, cache, noise)
    with pytest.raises(ValueError, match="hidden size 100"):
        wide = ar.ActorWeights(
            torch.zeros(984, 100, dtype=torch.bfloat16, device=device), torch.zeros(100, device=device),
            torch.zeros(100, 100, dtype=torch.bfloat16, device=device), torch.zeros(100, device=device),
            torch.zeros(8, 100, dtype=torch.bfloat16, device=device), torch.zeros(8, device=device),
        )
        ar.fused_actor_rollout_core(env, wide, states, cache, noise)
    with pytest.raises(ValueError, match="multiple of 32"):
        ar.fused_actor_rollout_core(
            env, weights, states.map(lambda x: x[:48]), cache.map(lambda x: x[:48]), noise[:, :, :48]
        )
    env33 = mgt.make("MiniGrid-Empty-5x5-v0", agent_view_size=33)
    with pytest.raises(ValueError, match="view size 33"):
        ar.fused_actor_rollout_core(env33, weights, states, cache, noise)
    with pytest.raises(ValueError, match="need CUDA"):
        ar._launch(env, weights, states.map(lambda x: x.cpu()), cache, noise)


def test_learner_raises_where_the_actor_kernel_does_not_run(device):
    env = mgt.make("MiniGrid-Empty-8x8-v0")
    init_fn, train_step = make_ppo(env, PPOConfig(rollout_steps=8, num_minibatches=1), hidden=100)
    state = init_fn(torch.Generator(device=device).manual_seed(0), 64)
    with pytest.raises(ValueError, match="hidden size 100"):
        train_step(state)


# The shapes beyond the built-in libraries (chip_smoke.py phase 37), each
# built at its first launch: views 3-31 for the rollout kernel, widths
# 32-512 and views 5 and 31 for the actor kernel, widths for the embed +
# dense-1 kernels.
@pytest.mark.parametrize("view", [3, 5, 9, 15, 17, 31])
def test_rollout_kernel_at_other_views(device, view):
    env = mgt.make("MiniGrid-DoorKey-8x8-v0", agent_view_size=view)
    assert fused_eligible(env, device)
    gen = torch.Generator(device=device).manual_seed(view)
    _, states = env.reset(1024, gen, device)
    states = states.replace(step_count=randint(gen, 1024, 0, states.max_steps))
    cache = env.batch_reset_cache(1024, 4, gen, device)
    actions = torch.randint(0, 7, (32, 1024), generator=gen, device=device, dtype=torch.int32)
    for compute_obs in (False, True):
        before = fr.KERNEL_LAUNCHES
        got = fr.fused_rollout_core(env, states, cache, actions, compute_obs)
        torch.cuda.synchronize()
        assert fr.KERNEL_LAUNCHES == before + 1
        _assert_same(got, fr.fused_rollout_reference(env, states, cache, actions, compute_obs))


@pytest.mark.parametrize("env_id", ["MiniGrid-Empty-8x8-v0", "MiniGrid-DoorKey-8x8-v0"])
@pytest.mark.parametrize("view, hidden", [(7, 32), (7, 96), (7, 128), (7, 512), (5, 64), (31, 64)])
def test_actor_kernel_at_other_shapes(device, env_id, view, hidden):
    # 1024 x 32 positions: about 1% of them are near-ties, and the contract
    # compares at least 99%.
    n, t = 1024, 32
    env = mgt.make(env_id, agent_view_size=view)
    assert ar.supports_fused_actor(env, device, n, hidden)
    gen = torch.Generator(device=device).manual_seed(hidden + view)
    _, states = env.reset(n, gen, device)
    states = states.replace(step_count=randint(gen, n, 0, states.max_steps))
    cache = env.batch_reset_cache(n, learner_resets(env, t), gen, device)
    model = ActorCritic(hidden, env.num_actions, view, generator=gen, device=device)
    with torch.no_grad():
        for i in range(4):
            bias = getattr(model, f"Dense_{i}").bias
            bias.copy_(0.1 * torch.randn(bias.shape, generator=gen, device=device))
    weights = ar.repack_actor_params(model)
    noise = ar.draw_bits(gen, (t, env.num_actions, n), device)
    before = ar.KERNEL_LAUNCHES
    final, traj = ar.fused_actor_rollout_core(env, weights, states, cache, noise)
    torch.cuda.synchronize()
    assert ar.KERNEL_LAUNCHES == before + 1 and int(traj["done"].sum()) > 0
    ar.check_trajectory(env, weights, states, cache, noise, final, traj, atol=ar.PLAIN_ATOL)


@pytest.mark.parametrize("hidden", [32, 96, 128, 512])
def test_embed_kernels_at_other_widths(device, hidden):
    packed, direction, w1, b1, dy = _embed_inputs(device, 4096, hidden, 3)
    before = dict(ed.KERNEL_LAUNCHES)
    out = ed.embed_dense1(w1, b1, packed, direction)
    want = ed.embed_dense1_reference(w1, b1, packed, direction)
    assert out.shape == (4096, hidden)
    assert float((out.float() - want.float()).abs().max()) <= 2e-2
    w1g, b1g = w1.clone().requires_grad_(), b1.clone().requires_grad_()
    got = torch.autograd.grad(ed.embed_dense1(w1g, b1g, packed, direction), (w1g, b1g), dy)
    plain = torch.autograd.grad(ed.embed_dense1_reference(w1g, b1g, packed, direction), (w1g, b1g), dy)
    for g, p in zip(got, plain):
        assert float((g - p.float()).abs().max()) <= 2e-2 * max(1.0, float(p.abs().max()))
    assert ed.KERNEL_LAUNCHES == {"fwd": before["fwd"] + 2, "bwd": before["bwd"] + 1}


@pytest.mark.parametrize("make, config, view, hidden, embeds", [
    (make_ppo, PPOConfig(rollout_steps=8, num_minibatches=2), 7, 128, (3, 2)),
    (make_impala, IMPALAConfig(rollout_steps=8, num_minibatches=2), 5, 64, (4, 2)),
])
def test_learners_take_the_kernels_at_other_shapes(device, make, config, view, hidden, embeds):
    env = mgt.make("MiniGrid-DoorKey-8x8-v0", agent_view_size=view)
    init_fn, train_step = make(env, config, hidden=hidden)
    state = init_fn(torch.Generator(device=device).manual_seed(0), 64)
    before = _launches()
    state, metrics = train_step(state)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_launches(), before)) == (1, 1, *embeds)
    assert all(np.isfinite(float(metrics[k])) for k in ("pg_loss", "value_loss", "entropy"))


def _obs_inputs(states):
    return states.grid, states.agent_x, states.agent_y, states.agent_dir, states.carrying


@pytest.mark.parametrize("see_through", [False, True])
@pytest.mark.parametrize("view_size", op.BUILT_VIEW_SIZES)
def test_obs_kernel_matches_plain_version(device, view_size, see_through):
    rng = np.random.default_rng(view_size)
    for n, w, h in ((4096, 9, 7), (1024, 22, 22)):
        states = state_from_numpy(random_states(rng, (n,), w, h), device)
        before = op.KERNEL_LAUNCHES
        got = op.fused_obs_packed(*_obs_inputs(states), view_size, see_through)
        torch.cuda.synchronize()
        assert op.KERNEL_LAUNCHES == before + 1
        want = op.fused_obs_packed_reference(*_obs_inputs(states), view_size, see_through)
        assert got.shape == (n, view_size, view_size) and torch.equal(got, want)


@pytest.mark.parametrize("see_through", [False, True])
@pytest.mark.parametrize("size", [5, 8, 25])  # 5x5 and 8x8 staged in shared memory, 25x25 read in place
@pytest.mark.parametrize("n", [1, 255, 257, 65536])
def test_obs_kernel_is_exact_on_both_grid_instantiations(device, n, size, see_through):
    staged = load_library("obs_packed").obs_packed_staged
    staged.argtypes, staged.restype = [ctypes.c_int] * 2, ctypes.c_int
    assert staged(size, size) == (size <= 8)
    states = state_from_numpy(random_states(np.random.default_rng(n + size), (n,), size, size), device)
    for view_size in op.BUILT_VIEW_SIZES:
        got = op.fused_obs_packed(*_obs_inputs(states), view_size, see_through)
        want = op.fused_obs_packed_reference(*_obs_inputs(states), view_size, see_through)
        assert got.shape == (n, view_size, view_size) and torch.equal(got, want), view_size


def test_obs_kernel_raises_on_what_it_does_not_take(device):
    # Every odd view from 3 to 31 is taken (17-31 since the runtime-V
    # path); 33, the first past them, an even and a too small one are not.
    states = state_from_numpy(random_states(np.random.default_rng(0), (64,), 8, 8), device)
    assert op.BUILT_VIEW_SIZES[-1] == 31
    for v in (33, 4, 1):
        with pytest.raises(ValueError, match=f"view size {v} was not built"):
            op.fused_obs_packed(*_obs_inputs(states), v)
    with pytest.raises(ValueError, match="need CUDA"):
        op._launch(*_obs_inputs(states.map(lambda x: x.cpu())), 7, False)
    with pytest.raises(ValueError, match="agent_x on cpu"):
        op.fused_obs_packed(states.grid, states.agent_x.cpu(), states.agent_y, states.agent_dir, states.carrying)
    with pytest.raises(ValueError, match="carrying must be int32"):
        op.fused_obs_packed(states.grid, states.agent_x, states.agent_y, states.agent_dir, states.carrying.long())


@pytest.mark.parametrize("view_size", [17, 19])
def test_a_wrapped_view_past_15_steps_on_the_card(device, view_size):
    # ViewSizeWrapper(DoorKey-8x8, v): a reset and 8 steps, each observation
    # through the kernel (one launch a step) equal to the plain one's.
    env = wr.ViewSizeWrapper(mgt.make("MiniGrid-DoorKey-8x8-v0"), view_size)
    gens = [torch.Generator(device=device).manual_seed(9) for _ in range(2)]
    n = 512
    obs, states = env.reset(n, gens[0])
    with obs_lib.plain_observations():
        want, plain_states = env.reset(n, gens[1])
    assert obs["image"].shape == (n, view_size, view_size, 3) and torch.equal(obs["image"], want["image"])
    for _ in range(8):
        actions = [torch.randint(0, env.num_actions, (n,), generator=g, device=device, dtype=torch.int32) for g in gens]
        before = op.KERNEL_LAUNCHES
        obs, states, *_ = env.step(states, actions[0], gens[0])
        torch.cuda.synchronize()
        assert op.KERNEL_LAUNCHES == before + 1
        with obs_lib.plain_observations():
            want, plain_states, *_ = env.step(plain_states, actions[1], gens[1])
        assert torch.equal(obs["image"], want["image"])
    for f in FIELDS:
        assert torch.equal(getattr(states, f), getattr(plain_states, f)), f


def test_env_observations_take_the_obs_kernel(device):
    env = mgt.make("MiniGrid-DoorKey-8x8-v0")
    gen = torch.Generator(device=device).manual_seed(0)
    before = op.KERNEL_LAUNCHES
    obs, states = env.reset(256, gen)
    obs, states, *_ = env.step(states, torch.full((256,), 2, dtype=torch.int32, device=device), gen)
    packed = env.observation_packed(states)
    torch.cuda.synchronize()
    assert op.KERNEL_LAUNCHES == before + 3
    with obs_lib.plain_observations():
        assert torch.equal(packed, env.observation_packed(states))
    assert op.KERNEL_LAUNCHES == before + 3


def test_the_plain_collector_launches_the_obs_kernel_unless_plain(device):
    env = mgt.make("MiniGrid-DoorKey-8x8-v0")
    gen = torch.Generator(device=device).manual_seed(4)
    _, states = env.reset(256, gen)
    model = ActorCritic(64, env.num_actions, env.agent_view_size, gen, device)
    for plain, want in ((False, 8), (True, 0)):
        before = op.KERNEL_LAUNCHES
        collect_trajectory(env, model, states, gen, 8, fused_actor=False, plain_obs=plain)
        torch.cuda.synchronize()
        assert op.KERNEL_LAUNCHES - before == want, plain


def test_plain_references_launch_no_obs_kernel(device):
    env = mgt.make("MiniGrid-DoorKey-8x8-v0")
    gen = torch.Generator(device=device).manual_seed(3)
    _, states = env.reset(256, gen)
    cache = env.batch_reset_cache(256, 4, gen, device)
    actions = torch.randint(0, 7, (8, 256), generator=gen, device=device, dtype=torch.int32)
    weights = _biased_actor(env, gen, device)
    noise = ar.draw_bits(gen, (8, env.num_actions, 256), device)
    before = _launches()
    fr.fused_rollout_reference(env, states, cache, actions, True)
    final, traj = ar.actor_rollout_reference(env, weights, states, cache, noise)
    ar.check_trajectory(env, weights, states, cache, noise, final, traj)
    torch.cuda.synchronize()
    assert _launches() == before
    for make, config in (
        (make_ppo, PPOConfig(rollout_steps=8, num_minibatches=2)),
        (make_impala, IMPALAConfig(rollout_steps=8, num_minibatches=2)),
    ):
        init_fn, train_step = make(env, config, hidden=64, _plain=True)
        state = init_fn(gen, 256)
        before = _launches()
        train_step(state)
        torch.cuda.synchronize()
        assert _launches() == before, make.__name__


# The tensor-core actor kernel on every instantiation kind: NoExt with a
# cache (DoorKey), a counter-reset ext with seeds (Dynamic-Obstacles), a
# cached ext's scalars (GoToDoor), BabyAI's planes (GoToLocal).
ACTOR_KINDS = {
    "cache": "MiniGrid-DoorKey-8x8-v0",
    "counter": "MiniGrid-Dynamic-Obstacles-8x8-v0",
    "cached_ext": "MiniGrid-GoToDoor-8x8-v0",
    "babyai": "BabyAI-GoToLocal-v0",
}
ACTOR_MAX_STEPS = 6  # short episodes: resets inside every run


@pytest.mark.parametrize("hidden", [64, 256])
@pytest.mark.parametrize("n", [32, 96, 8224])  # a block, one and a half, and 128.5 blocks of 64 envs
@pytest.mark.parametrize("kind", list(ACTOR_KINDS))
def test_actor_kernel_takes_every_block_shape(device, kind, n, hidden):
    env = mgt.make(ACTOR_KINDS[kind], max_steps=ACTOR_MAX_STEPS)
    t = max(16, -(-16384 // n))  # at least 16384 positions for the near-tie share
    gen = torch.Generator(device=device).manual_seed(9)
    _, states = env.reset(n, gen)
    weights = _biased_actor(env, gen, device, hidden)
    cache = seeds = None
    if ar.counter_reset(env):
        seeds = torch.randint(-(2**31), 2**31, (n, 2), generator=gen, device=device, dtype=torch.int32)
    else:
        cache = env.batch_reset_cache(n, t // ACTOR_MAX_STEPS + 2, gen)
    noise = ar.draw_bits(gen, (t, env.num_actions, n), device)
    before = ar.KERNEL_LAUNCHES
    final, traj = ar.fused_actor_rollout_core(env, weights, states, cache, noise, seeds)
    torch.cuda.synchronize()
    assert ar.KERNEL_LAUNCHES == before + 1
    assert traj["obs"].shape == (t, n, 49) and int(traj["done"].sum()) >= n
    ar.check_trajectory(env, weights, states, cache, noise, final, traj, ar.PLAIN_ATOL, reset_seeds=seeds)


@pytest.mark.parametrize("hidden", [32, 64, 256])  # 32: dy padded to the kernel's 64 columns
@pytest.mark.parametrize("m", [1, 4097, 131072 + 17])
def test_embed_backward_matches_autograd_and_repeats(device, m, hidden):
    packed, direction, w1, b1, dy = _embed_inputs(device, m, hidden, 4)
    before = ed.KERNEL_LAUNCHES["bwd"]
    dw, db = ed._backward(packed, direction, dy)
    torch.cuda.synchronize()
    assert ed.KERNEL_LAUNCHES["bwd"] == before + 1
    assert dw.shape == (49 * 20 + 4, hidden) and db.shape == (hidden,) and dw.dtype == torch.float32
    w1p, b1p = w1.clone().requires_grad_(), b1.clone().requires_grad_()
    want = torch.autograd.grad(ed.embed_dense1_reference(w1p, b1p, packed, direction), (w1p, b1p), dy)
    for got, ref in zip((dw, db), want):
        scale = max(1.0, float(ref.abs().max()))
        torch.testing.assert_close(got, ref.float(), rtol=0, atol=2e-2 * scale)
    dw2, db2 = ed._backward(packed, direction, dy)
    assert torch.equal(dw2, dw) and torch.equal(db2, db)  # bit-identical twice


# The classic zoo's last slice: each new ext's instantiations of both
# kernels, and the default-hook families of the slice through K1's NoExt.
ZOO_EXT_IDS = [
    "MiniGrid-Unlock-v0",
    "MiniGrid-BlockedUnlockPickup-v0",
    "MiniGrid-KeyCorridorS6R3-v0",
    "MiniGrid-ObstructedMaze-2Dlh-v0",
    "MiniGrid-MemoryS17Random-v0",
    "MiniGrid-PutNear-8x8-N3-v0",
    "MiniGrid-RedBlueDoors-8x8-v0",
]
ZOO_NOEXT_IDS = [
    "MiniGrid-DistShift1-v0",
    "MiniGrid-LavaGapS7-v0",
    "MiniGrid-LockedRoom-v0",
    "MiniGrid-Playground-v0",
    "MiniGrid-MultiRoom-N6-v0",
]
_DIRS = ((1, 0), (0, 1), (-1, 0), (0, -1))


def _cell_of(states, kind, color=None):
    """Per env, the (x, y) of a cell of type ``kind`` (and ``color``), or
    (-1, -1)."""
    n, w, h = states.grid.shape
    m = (states.grid & 0xFF) == kind
    if color is not None:
        m = m & (((states.grid >> 8) & 0xFF) == color[:, None, None])
    idx = m.reshape(n, -1).int().argmax(dim=1)
    found = m.reshape(n, -1).any(dim=1)
    return torch.where(found, idx // h, -1).int(), torch.where(found, idx % h, -1).int()


def _face(states, tx, ty, pose):
    """The agents of the envs ``pose`` moved onto a free cell next to (tx,
    ty) and turned to face it, where there is one."""
    n, w, h = states.grid.shape
    rows = torch.arange(n, device=states.device)
    ax, ay, ad = states.agent_x, states.agent_y, states.agent_dir
    placed = ~pose | (tx < 0)
    for d, (dx, dy) in enumerate(_DIRS):
        cx, cy = tx - dx, ty - dy
        inside = (cx >= 1) & (cx < w - 1) & (cy >= 1) & (cy < h - 1)
        cell = states.grid[rows, cx.clamp(0, w - 1).long(), cy.clamp(0, h - 1).long()]
        take = ~placed & inside & ((cell & 0xFF) == 1)
        ax, ay, ad = torch.where(take, cx, ax), torch.where(take, cy, ay), torch.where(take, d, ad).int()
        placed = placed | take
    return states.replace(agent_x=ax.int(), agent_y=ay.int(), agent_dir=ad)


def _zoo_states(env_id, env, states, gen):
    """``states`` with about half of the agents put where the family's
    events happen on the next action: facing the door with its key in
    hand (Unlock), the target (the pickup targets, ObstructedMaze's blue
    ball or a box with a key inside), the cue or the success and failure
    cells (Memory), a free cell next to the target with the object to move
    in hand (PutNear), the red or the blue door (RedBlueDoors)."""
    n = states.step_count.shape[0]
    device = states.device
    coin = torch.randint(0, 4, (n,), generator=gen, device=device)
    extra = states.extra
    if env_id.startswith("MiniGrid-Unlock"):
        dx, dy = extra["door_pos"][:, 0], extra["door_pos"][:, 1]
        color = (states.grid[torch.arange(n, device=device), dx.long(), dy.long()] >> 8) & 0xFF
        states = states.replace(carrying=torch.where(coin < 2, 5 | (color << 8), states.carrying).int())
        return _face(states, dx, dy, coin < 2)
    if "UnlockPickup" in env_id or "KeyCorridor" in env_id:
        return _face(states, *_cell_of(states, env.target_kind, extra["target_color"]), coin < 2)
    if "ObstructedMaze" in env_id:
        box_x, box_y = _cell_of(states, 7)
        ball_x, ball_y = _cell_of(states, 6, torch.full((n,), 2, device=device))
        states = _face(states, box_x, box_y, coin < 2)
        return _face(states, ball_x, ball_y, coin == 2)
    if "Memory" in env_id:
        mid = env.height // 2
        states = _face(states, torch.full_like(coin, 1).int(), torch.full_like(coin, mid - 1).int(), coin < 2)
        states = _face(states, extra["success_pos"][:, 0], extra["success_pos"][:, 1], coin == 2)
        return _face(states, extra["failure_pos"][:, 0], extra["failure_pos"][:, 1], coin == 3)
    if "PutNear" in env_id:
        tx, ty = extra["target_pos"][:, 0], extra["target_pos"][:, 1]
        rows = torch.arange(n, device=device)
        nx, ny = torch.full_like(tx, -1), torch.full_like(ty, -1)
        for dx, dy in _DIRS:
            cx, cy = (tx + dx).clamp(0, env.width - 1), (ty + dy).clamp(0, env.height - 1)
            empty = (states.grid[rows, cx.long(), cy.long()] & 0xFF) == 1
            take = (nx < 0) & empty
            nx, ny = torch.where(take, cx, nx), torch.where(take, cy, ny)
        move = extra["move_type"] | (extra["move_color"] << 8)
        states = states.replace(carrying=torch.where(coin < 2, move, states.carrying).int())
        return _face(states, nx, ny, coin < 2)
    if "RedBlueDoors" in env_id:
        states = _face(states, extra["red_pos"][:, 0], extra["red_pos"][:, 1], coin < 2)
        return _face(states, extra["blue_pos"][:, 0], extra["blue_pos"][:, 1], coin == 2)
    return states


@pytest.mark.parametrize("compute_obs", [False, True])
@pytest.mark.parametrize("n", [33, 4127])  # a warp's tail lane, and a block's
@pytest.mark.parametrize("env_id", ZOO_EXT_IDS + ZOO_NOEXT_IDS)
def test_zoo_k1_matches_plain_version(device, env_id, n, compute_obs):
    env = mgt.make(env_id, max_steps=48)
    gen = torch.Generator(device=device).manual_seed(12)
    _, states = env.reset(n, gen)
    states = _zoo_states(env_id, env, states.replace(step_count=randint(gen, n, 0, states.max_steps)), gen)
    cache = env.batch_reset_cache(n, 3, gen)
    actions = torch.randint(0, env.num_actions, (64, n), generator=gen, device=device, dtype=torch.int32)
    before = fr.KERNEL_LAUNCHES
    got = fr.fused_rollout_core(env, states, cache, actions, compute_obs)
    torch.cuda.synchronize()
    assert fr.KERNEL_LAUNCHES == before + 1
    want = fr.fused_rollout_reference(env, states, cache, actions, compute_obs)
    for f in FIELDS:
        assert torch.equal(getattr(got[0], f), getattr(want[0], f)), f
    assert (got[0].extra is None) == (want[0].extra is None) == (env.fused_ext is None or env.fused_ext.n_scalars == 0)
    if want[0].extra is not None:
        _assert_extra_same(got[0].extra, want[0].extra)
    assert [int(x) for x in got[2:]] == [int(x) for x in want[2:]]
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-6)
    assert int(got[2]) >= n // 2 and int(got[4]) >= 1


@pytest.mark.parametrize("n", [96, 4128])  # K2 takes multiples of 32: one and a half blocks, a block's tail
@pytest.mark.parametrize("env_id", ZOO_EXT_IDS)
def test_zoo_k2_meets_the_contracts(device, env_id, n):
    env = mgt.make(env_id, max_steps=24)
    gen = torch.Generator(device=device).manual_seed(13)
    _, states = env.reset(n, gen)
    states = _zoo_states(env_id, env, states, gen)
    weights = _biased_actor(env, gen, device)
    cache = env.batch_reset_cache(n, 4, gen)
    noise = ar.draw_bits(gen, (64, env.num_actions, n), device)
    before = ar.KERNEL_LAUNCHES
    final, traj = ar.fused_actor_rollout_core(env, weights, states, cache, noise)
    torch.cuda.synchronize()
    assert ar.KERNEL_LAUNCHES == before + 1
    assert int(traj["done"].sum()) >= n
    ar.check_trajectory(env, weights, states, cache, noise, final, traj, ar.PLAIN_ATOL)


def test_zoo_events_happen_in_the_posed_states(device):
    # The posed states make each family's event: after one step of the
    # plain version on the action the pose is for, the ext ends episodes
    # (half of them posed; RedBlueDoors' failure is the quarter posed at
    # the blue door: toggling the red one first ends nothing).
    wanted = {
        "MiniGrid-Unlock-v0": 5, "MiniGrid-BlockedUnlockPickup-v0": 3, "MiniGrid-KeyCorridorS6R3-v0": 3,
        "MiniGrid-RedBlueDoors-8x8-v0": 5, "MiniGrid-PutNear-8x8-N3-v0": 4, "MiniGrid-MemoryS17Random-v0": 2,
    }
    for env_id, action in wanted.items():
        env = mgt.make(env_id)
        gen = torch.Generator(device=device).manual_seed(14)
        _, states = env.reset(1024, gen)
        states = _zoo_states(env_id, env, states, gen)
        stepped, reward = env.step_env(states, torch.full((1024,), action, dtype=torch.int32, device=device))
        assert int(stepped.terminated.sum()) >= 128, env_id


# -- the rest of BabyAI (chip_smoke.py phases 21, 23 and 24 at small sizes) ----------

NEW_BABYAI_MODULES = ("open", "pickup", "putnext", "unlock", "other", "levelgen")
NEW_BABYAI_IDS = sorted(
    i for i in mgt.registered_ids()
    if type(mgt.make(i)).__module__ in {f"minigrid_tpu_torch.envs.babyai.{m}" for m in NEW_BABYAI_MODULES}
)
NEW_BABYAI_ACTOR_IDS = [
    "BabyAI-OpenDoorsOrderN4Debug-v0",
    "BabyAI-PickupDistDebug-v0",
    "BabyAI-PutNextS5N2Carrying-v0",
    "BabyAI-KeyInBox-v0",
    "BabyAI-ActionObjDoor-v0",
    "BabyAI-MiniBossLevel-v0",
]
VERIFIER_FILES = sorted(str(p) for p in (Path(__file__).parent / "golden").glob("verifier_*.npz"))


def test_the_new_babyai_modules_hold_64_ids():
    assert len(NEW_BABYAI_IDS) == 64 and len(VERIFIER_FILES) == 16


@pytest.mark.parametrize("env_id", NEW_BABYAI_IDS)
def test_new_babyai_ids_take_k1_bit_for_bit(device, env_id):
    # 512 envs x 32 steps, episode ages spread, R from learner_resets: the
    # Carrying levels start with an object in hand, KeyInBox's box holds its
    # key, the Debug levels fail strict leaves.
    env = mgt.make(env_id)
    n, steps = 512, 32
    gen = torch.Generator(device=device).manual_seed(13)
    _, states = env.reset(n, gen)
    states = states.replace(step_count=randint(gen, n, 0, states.max_steps))
    r = learner_resets(env, steps)
    cache = env.batch_reset_cache(n, r, gen)
    actions = torch.randint(0, env.num_actions, (steps, n), generator=gen, device=device, dtype=torch.int32)
    before = fr.KERNEL_LAUNCHES
    got = fr.fused_rollout_core(env, states, cache, actions, False)
    torch.cuda.synchronize()
    assert fr.KERNEL_LAUNCHES == before + 1
    want = fr.fused_rollout_reference(env, states, cache, actions, False)
    _assert_same(got, want)
    _assert_extra_same(got[0].extra, want[0].extra)
    assert int(got[2]) > 0 and int(got[4]) <= r


@pytest.mark.parametrize("env_id", NEW_BABYAI_ACTOR_IDS)
def test_actor_kernel_runs_the_new_babyai_modules(device, env_id):
    env = mgt.make(env_id)
    n, t = 1024, 32
    gen = torch.Generator(device=device).manual_seed(9)
    _, states = env.reset(n, gen)
    states = states.replace(step_count=randint(gen, n, 0, states.max_steps))
    weights = _biased_actor(env, gen, device)
    cache = env.batch_reset_cache(n, learner_resets(env, t), gen)
    noise = ar.draw_bits(gen, (t, env.num_actions, n), device)
    before = ar.KERNEL_LAUNCHES
    final, traj = ar.fused_actor_rollout_core(env, weights, states, cache, noise)
    torch.cuda.synchronize()
    assert ar.KERNEL_LAUNCHES == before + 1
    assert 0 < int(traj["done"].int().sum(dim=0).max()) <= cache.step_count.shape[1]
    ar.check_trajectory(env, weights, states, cache, noise, final, traj, ar.PLAIN_ATOL)


@pytest.mark.parametrize("path", VERIFIER_FILES, ids=lambda p: Path(p).name)
def test_verifier_fixtures_replay_through_k1(device, path):
    before = fr.KERNEL_LAUNCHES
    steps = golden.replay_verifier(path, device)
    assert steps > 0 and fr.KERNEL_LAUNCHES - before == steps


WFC_HEURISTICS = [
    ("entropy", "weighted", False),
    ("anti-entropy", "random", False),
    ("random", "rarest", False),
    ("simple", "most-common", False),
    ("lexical", "lexical", False),
    ("spiral", "weighted", False),
    ("hilbert", "random", False),
    ("entropy", "weighted", True),
]


def _wfc_pair(device, adj, weights, n, shape, periodic, loc="entropy", choice="weighted", backtracking=False,
              max_attempts=8, seed=9):
    """The kernel's and the plain version's solves of n waves on the same
    seeds; the kernel launched once, the plain version never."""
    gen = torch.Generator(device=device).manual_seed(seed)
    snapshot = gen.get_state()
    before = wk.KERNEL_LAUNCHES
    args = (adj, weights, n, shape, periodic, max_attempts, loc, choice, backtracking)
    got = wfc_solver.wfc_solve(gen, *args, with_stats=True)
    torch.cuda.synchronize()
    assert wk.KERNEL_LAUNCHES == before + 1
    gen.set_state(snapshot)
    want = wfc_solver.wfc_solve(gen, *args, with_stats=True, plain=True)
    assert wk.KERNEL_LAUNCHES == before + 1
    return got, want


def _wfc_assert_same(got, want):
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for k, v in want[2].items():
        assert torch.equal(got[2][k], v), k


def _wfc_both(device, preset, n, shape, loc="entropy", choice="weighted", backtracking=False):
    t = build_tables(WFC_PRESETS_ALL[preset])
    return _wfc_pair(device, t["adj"], t["weights"], n, shape, WFC_PRESETS_ALL[preset].output_periodic, loc, choice,
                     backtracking, seed=7)


@pytest.mark.parametrize("loc,choice,backtracking", WFC_HEURISTICS)
def test_wfc_kernel_matches_plain_version_on_every_heuristic(device, loc, choice, backtracking):
    got, want = _wfc_both(device, "MazeSimple", 96, (13, 11), loc, choice, backtracking)
    _wfc_assert_same(got, want)


@pytest.mark.parametrize("preset", sorted(WFC_PRESETS_ALL))
def test_wfc_kernel_matches_plain_version_on_every_preset(device, preset):
    # Up to 229 patterns (Maze): four 64-bit words a cell.
    got, want = _wfc_both(device, preset, 8, (12, 12))
    _wfc_assert_same(got, want)


def _wfc_full_blocks(device, p, shape, backtracking=False):
    """The wave count that gives every SM one full block."""
    props = torch.cuda.get_device_properties(device)
    layout = wk.wfc_solve_layout(
        p, *shape, backtracking, 1 << 20, props.multi_processor_count, props.shared_memory_per_block_optin
    )
    return layout["waves_per_block"] * props.multi_processor_count


@pytest.mark.parametrize("count", ["one", "all blocks full less one", "all blocks full and one", "133"])
def test_wfc_kernel_matches_plain_version_at_every_wave_count(device, count):
    # MazeSimple at 23x23: one wave a block up to the SM count (133: two a
    # block, the last block's range one wave short); about the count that
    # fills every SM's block, warps idle on one side and warps taking a second
    # wave on the other.
    t = build_tables(WFC_PRESETS_ALL["MazeSimple"])
    full = _wfc_full_blocks(device, t["adj"].shape[1], (23, 23))
    n = {"one": 1, "all blocks full less one": full - 1, "all blocks full and one": full + 1, "133": 133}[count]
    got, want = _wfc_pair(device, t["adj"], t["weights"], n, (23, 23), False)
    assert got[0].shape == (n, 23, 23)
    _wfc_assert_same(got, want)


@pytest.mark.parametrize(
    "preset,backtracking", [(preset, False) for preset in sorted(WFC_PRESETS_ALL)] + [("Maze", True)]
)
def test_wfc_kernel_matches_plain_version_on_every_preset_at_23x23(device, preset, backtracking):
    # Up to 229 patterns (Maze, four words a cell, its snapshot too).
    got, want = _wfc_both(device, preset, 4, (23, 23), backtracking=backtracking)
    _wfc_assert_same(got, want)


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("backtracking", [False, True])
def test_wfc_kernel_takes_an_adjacency_that_is_not_symmetric(device, periodic, backtracking):
    # adj[d] != adj[(d + 2) % 4].T: the support table is adj transposed, not
    # the opposite direction's rows.  Contradictions, restarts and bans.
    rng = np.random.default_rng(12)
    adj = rng.random((4, 9, 9)) < 0.55
    assert not all(np.array_equal(adj[d], adj[(d + 2) % 4].T) for d in range(4))
    weights = rng.integers(1, 6, 9).astype(np.float32)
    got, want = _wfc_pair(device, adj, weights, 200, (9, 7), periodic, backtracking=backtracking, max_attempts=3)
    assert int(want[2]["contradictions"].sum()) > 0
    _wfc_assert_same(got, want)


def test_wfc_kernel_takes_its_tables_from_the_host_or_the_card(device):
    # The wrapper reads adj on the host and keeps its tables on the card once
    # made; tensors on the card give the same solves.
    t = build_tables(WFC_PRESETS_ALL["DungeonMazeScaled"])
    host = _wfc_pair(device, t["adj"], t["weights"], 64, (13, 11), True)
    card = _wfc_pair(device, torch.as_tensor(t["adj"], device=device), torch.as_tensor(t["weights"], device=device),
                     64, (13, 11), True)
    _wfc_assert_same(host[0], host[1])
    _wfc_assert_same(card[0], host[0])
    _wfc_assert_same(card[1], host[1])


def test_wfc_layout_matches_its_python_mirror(device):
    lib = load_library("wfc_solve")
    layout = lib.wfc_solve_layout
    layout.argtypes = [ctypes.c_int] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    layout.restype = ctypes.c_int
    one = lib.wfc_solve_smem_bytes
    one.argtypes, one.restype = [ctypes.c_int] * 4, ctypes.c_longlong
    props = torch.cuda.get_device_properties(device)
    sms, limit = props.multi_processor_count, props.shared_memory_per_block_optin
    patterns = {build_tables(c)["adj"].shape[1] for c in WFC_PRESETS_ALL.values()} | {1, 64, 65, 256}
    keys = ("block_bytes", "wave_bytes", "waves_per_block", "smem_bytes")
    for p in sorted(patterns):
        for size in (5, 12, 23, 41):
            for backtracking in (0, 1):
                for n in (1, 64, sms, sms + 1, 3037, 20480):
                    out = (ctypes.c_longlong * 4)()
                    err = layout(p, size, size, backtracking, n, sms, limit, out)
                    want = wk.wfc_solve_layout(p, size, size, backtracking, n, sms, limit)
                    assert list(out) == [want[k] for k in keys], (p, size, backtracking, n)
                    assert (err == 0) == (want["waves_per_block"] > 0)
                assert one(p, size, size, backtracking) == want["block_bytes"] + want["wave_bytes"]


def test_wfc_kernel_rejects_what_it_does_not_take(device):
    adj = np.ones((4, 300, 300), bool)
    seeds = torch.zeros((4, 2), dtype=torch.int32, device=device)
    with pytest.raises(ValueError, match="patterns"):
        wk.wfc_solve_kernel(seeds, adj, torch.ones(300), None, (5, 5), False, 1, "entropy", "weighted", False)
    t = build_tables(WFC_PRESETS_ALL["Maze"])
    with pytest.raises(ValueError, match="shared memory"):
        wk.wfc_solve_kernel(seeds, t["adj"], torch.ones(229), None, (200, 200), False, 1, "entropy", "weighted", True)
    with pytest.raises(ValueError, match="plain=True"):
        wfc_solver.wfc_solve(None, t["adj"], t["weights"], 1, (5, 5), False, on_backtrack=lambda: None, device=device)


def test_execute_wfc_takes_its_hooks_to_the_plain_version_only_when_asked(device):
    # On the card the hooks reach the kernel's wrapper, which refuses them,
    # unless the caller asks for the plain version; the two solves agree.
    config = WFC_PRESETS_ALL["MazeSimple"]
    before = wk.KERNEL_LAUNCHES
    with pytest.raises(ValueError, match="plain=True"):
        wfcenv.execute_wfc(torch.Generator(device=device).manual_seed(0), config, (9, 9), on_choice=lambda *c: None)
    choices = []
    grid, stats = wfcenv.execute_wfc(
        torch.Generator(device=device).manual_seed(0), config, (9, 9), on_choice=lambda *c: choices.append(c), plain=True
    )
    assert wk.KERNEL_LAUNCHES == before and len(choices) == stats["collapses"]
    kgrid, kstats = wfcenv.execute_wfc(torch.Generator(device=device).manual_seed(0), config, (9, 9))
    assert wk.KERNEL_LAUNCHES == before + 1
    assert (grid is None) == (kgrid is None) and (grid is None or np.array_equal(grid, kgrid))
    assert all(stats[k] == kstats[k] for k in stats if k != "solve duration")


@pytest.mark.parametrize("preset", sorted(WFC_PRESETS))
def test_wfc_levels_on_the_card_match_the_reference_corpus(device, preset):
    ref = np.load(Path(__file__).parent / "golden" / "wfc_ref_corpus.npz")[f"{preset}_walls"]
    env = mgt.make(f"MiniGrid-WFC-{preset}-v0")
    before = wk.KERNEL_LAUNCHES
    _, states = env.reset(ref.shape[0], torch.Generator(device=device).manual_seed(11))
    assert wk.KERNEL_LAUNCHES == before + 1
    ours = (cell_type(states.grid) == OBJ_WALL).cpu().numpy()[:, 1:-1, 1:-1]
    tvd, density, ref_density, limit = golden.wfc_corpus_check(ours, ref)
    assert tvd < 0.10 and abs(density - ref_density) < limit, (tvd, density, ref_density, limit)


# The gymnasium shim on the card (compat/gym.py): six ids of every kind,
# the Dynamic-Obstacles host walk, a RoomGrid maze, BabyAI with a carried
# object and the boss level, and a WFC preset solved on the host.
SHIM_IDS = (
    "MiniGrid-DoorKey-8x8-v0",
    "MiniGrid-Dynamic-Obstacles-8x8-v0",
    "MiniGrid-ObstructedMaze-2Dlh-v0",
    "BabyAI-PutNextS5N2Carrying-v0",
    "BabyAI-BossLevel-v0",
    "MiniGrid-WFC-MazeSimple-v0",
)


def _shim_run(env, seed: int, actions) -> list:
    """reset(seed), the actions with an unseeded reset where an episode
    ends: every call's observation, reward and flags."""
    out = [env.reset(seed=seed)[0]]
    for a in actions:
        obs, reward, terminated, truncated, _ = env.step(int(a))
        out.append((obs, reward, terminated, truncated))
        if terminated or truncated:
            out.append(env.reset()[0])
    return out


def _same_call(a, b) -> bool:
    if isinstance(a, dict):
        a, b = (a, 0.0, False, False), (b, 0.0, False, False)
    (oa, ra, ta, ua), (ob, rb, tb, ub) = a, b
    return (
        np.array_equal(oa["image"], ob["image"])
        and oa["direction"] == ob["direction"]
        and oa["mission"] == ob["mission"]
        and (ta, ua) == (tb, ub)
        and abs(ra - rb) <= 1e-6 * abs(rb)
    )


@pytest.mark.parametrize("env_id", SHIM_IDS)
def test_shim_parity_episode_on_the_card_equals_the_cpu(device, env_id):
    """The shim's parity episode on the card equals the same episode on the
    CPU, and each reset and step on the card launches the observation
    kernel exactly once."""
    from minigrid_tpu_torch.compat import gym_make

    actions = np.random.default_rng(4).integers(0, 7, 48)
    card = gym_make(env_id, parity=True, device=device)
    before = op.KERNEL_LAUNCHES
    got = _shim_run(card, 21, actions)
    torch.cuda.synchronize()
    assert op.KERNEL_LAUNCHES - before == len(got)
    assert card.state.grid.is_cuda
    want = _shim_run(gym_make(env_id, parity=True, device="cpu"), 21, actions)
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(got, want)):
        assert _same_call(a, b), (env_id, k)


@pytest.mark.parametrize("parity", [False, True])
def test_shim_pickles_on_the_card(device, parity):
    """A mid-episode pickle of the shim on the card continues the episode
    and the reset after it, its state back on the card."""
    import pickle

    from minigrid_tpu_torch.compat import gym_make

    env = gym_make("BabyAI-GoToLocal-v0", parity=parity, device=device)
    env.reset(seed=5)
    for a in (2, 0, 2):
        env.step(a)
    clone = pickle.loads(pickle.dumps(env))
    assert clone.state.grid.is_cuda and clone.hash() == env.hash()
    for a in (2, 1, 2, 2, 5, 2):
        assert _same_call(env.step(a)[:4], clone.step(a)[:4])
    assert _same_call(env.reset()[0], clone.reset()[0])


def test_shim_normal_mode_on_the_card(device):
    """Normal mode: reset(seed=3) twice gives the same level; a WFC reset
    launches the solver kernel for its one wave; the frame equals the CPU's
    frame of the same state."""
    from minigrid_tpu_torch.compat import gym_make

    for env_id in ("BabyAI-GoToLocal-v0", "MiniGrid-WFC-MazeSimple-v0"):
        env = gym_make(env_id, device=device, render_mode="rgb_array")
        before = wk.KERNEL_LAUNCHES
        first = env.reset(seed=3)[0]
        level = env.hash()
        assert wk.KERNEL_LAUNCHES - before == (1 if "WFC" in env_id else 0)
        for a in (1, 2, 2):
            env.step(a)
        again = env.reset(seed=3)[0]
        assert env.hash() == level and np.array_equal(first["image"], again["image"])
        cpu_frame = env.env.get_frame(env.state.map(lambda t: t.cpu()))[0].numpy()
        assert np.array_equal(env.render(), cpu_frame)


# -- the rest of the user surface: the bot, demos, checkpoints, the CLIs --


def _bot_run(env, state, device):
    """The oracle bot and ``step_env`` for up to 300 steps: (actions, the
    final state)."""
    from minigrid_tpu_torch.utils.babyai_bot import BabyAIBot

    bot, actions, last = BabyAIBot(env, state), [], None
    for _ in range(300):
        last = bot.replan(state, last)
        actions.append(last)
        state, _ = env.step_env(state, torch.tensor([last], dtype=torch.int32, device=device))
        if bool(state.terminated[0] | state.truncated[0]):
            break
    return actions, state


@pytest.mark.parametrize("env_id", ["BabyAI-PickupLoc-v0", "BabyAI-BossLevel-v0"])
def test_bot_on_the_card_equals_the_cpu(device, env_id):
    env = mgt.make(env_id)
    _, cpu_state = env.reset(1, torch.Generator().manual_seed(0), "cpu")
    got = _bot_run(env, cpu_state.map(lambda t: t.to(device)), device)
    want = _bot_run(env, cpu_state, "cpu")
    assert got[0] == want[0]
    for (k, a), (_, b) in zip(tree_leaves(got[1]), tree_leaves(want[1])):
        assert torch.equal(a.cpu(), b), k


def test_demos_on_the_card_launch_the_observation_kernel_once_an_observation(device):
    from minigrid_tpu_torch.utils.demos import generate_demo

    env = mgt.make("BabyAI-GoToRedBallGrey-v0")
    before = op.KERNEL_LAUNCHES
    demo = generate_demo(env, 0)
    torch.cuda.synchronize()
    assert demo is not None and demo.reward > 0
    assert op.KERNEL_LAUNCHES - before == len(demo.actions) + 1


def test_checkpoint_resume_on_the_card_is_bit_exact(device, tmp_path):
    from minigrid_tpu_torch.utils import checkpoint

    env = mgt.make("MiniGrid-Empty-8x8-v0")
    config = PPOConfig(rollout_steps=16, num_minibatches=2)
    init_fn, train_step = make_ppo(env, config, hidden=64)
    state, _ = train_step(init_fn(torch.Generator(device=device).manual_seed(1), 256))
    checkpoint.save(str(tmp_path / "state"), state)
    resumed = checkpoint.load(str(tmp_path / "state"), state)
    assert resumed.params.Dense_0.kernel.is_cuda and resumed.generator.device.type == "cuda"
    _, resumed_step = make_ppo(env, config, hidden=64)
    cont, m_cont = train_step(state)
    res, m_res = resumed_step(resumed)
    assert all(torch.equal(m_cont[k], m_res[k]) for k in m_cont)
    for name, p in cont.params.state_dict().items():
        assert torch.equal(p, res.params.state_dict()[name]), name


def test_benchmark_cli_on_the_card_takes_the_rollout_kernel(device):
    from minigrid_tpu_torch.benchmark import benchmark

    before = fr.KERNEL_LAUNCHES
    r = benchmark("MiniGrid-LavaGapS7-v0", num_resets=2, num_frames=2, num_envs=256, num_steps=16)
    assert fr.KERNEL_LAUNCHES - before == 2
    assert all(r[k] > 0 for k in ("reset_ms", "world_render_fps", "agent_view_fps", "env_steps_per_sec"))


def test_manual_control_frames_on_the_card_equal_the_cpu(device):
    """Every frame the controller draws on the card equals the CPU's frame
    of the same state (the levels themselves differ between the card's and
    the CPU's generators), and each frame and each reset's observation
    launches the observation kernel once."""
    from minigrid_tpu_torch.manual_control import ManualControl

    class Key:
        def __init__(self, key):
            self.key = key

    env = mgt.make("MiniGrid-DoorKey-5x5-v0")
    mc = ManualControl(env, seed=3, device=device)
    shots = []
    mc.render = lambda: shots.append((mc.frame(), mc.state.map(lambda t: t.cpu())))
    before = op.KERNEL_LAUNCHES
    mc.reset()
    for key in ("left", "up", "right", "up", "tab", "space", "backspace"):
        mc.key_handler(Key(key))
    assert op.KERNEL_LAUNCHES - before == len(shots) + 2 == 10
    for frame, state in shots:
        assert np.array_equal(frame, env.get_frame(state)[0].numpy())


MESH_CASE = dict(env_id="MiniGrid-Empty-8x8-v0", rollout_steps=16, num_minibatches=2, hidden=64, seed=4)


def test_one_nccl_rank_trains_as_the_mesh_less_learner(device):
    # One spawned rank on cuda:0: its steps take the kernels, and its
    # collection and update equal the mesh-less learner's bit for bit (an
    # all-reduce over one rank and the division by 1 change nothing).
    from minigrid_tpu_torch.parallel.mp_worker import run_workers

    case = dict(MESH_CASE, num_envs=1024, ppo_steps=2)
    out = run_workers({"meshless": case}, 1, backend="nccl", device="cuda:0", timeout=300).results[0]["meshless"]
    want = {"K1": 0, "K2": 1, "K4": 1, "K3 fwd": 3, "K3 bwd": 2}
    assert all(s["launches"] == want for s in out["ppo"])
    assert out["collection_equal"]
    assert out["update_differences"] == {"params": 0.0, "mu": 0.0, "nu": 0.0, "metrics": 0.0}


def test_two_gloo_ranks_share_the_card_and_keep_equal_parameters(device):
    from minigrid_tpu_torch.parallel.mp_worker import run_workers

    case = dict(MESH_CASE, num_envs=2048, ppo_steps=2, impala_steps=1)
    results = run_workers({"learners": case}, 2, backend="gloo", device="cuda:0", timeout=300).results
    for out in (r["learners"] for r in results):
        assert all(s["same"] for s in out["ppo"] + out["impala"])
        assert all(s["log"] == out["ppo_expected"] for s in out["ppo"])
        assert all(s["launches"] == {"K1": 0, "K2": 1, "K4": 1, "K3 fwd": 3, "K3 bwd": 2} for s in out["ppo"])
        assert out["impala"][0]["launches"] == {"K1": 0, "K2": 1, "K4": 1, "K3 fwd": 4, "K3 bwd": 2}
    assert results[0]["learners"]["ppo"][-1]["metrics"] == results[1]["learners"]["ppo"][-1]["metrics"]


def test_nccl_refuses_two_ranks_on_one_card(device, tmp_path):
    from minigrid_tpu_torch.parallel.mesh import make_mesh

    if torch.cuda.device_count() >= 2:
        pytest.skip("two cards: two NCCL ranks take one each")
    with pytest.raises(ValueError, match="two\\s+ranks would share one"):
        make_mesh(backend="nccl", rank=0, world_size=2, init_method=f"file://{tmp_path / 'store'}")


# -- a family written outside the package (chip_smoke.py phase 36 at small sizes) --


def _turns_case(device, header, n, r=6, steps=64, seed=21):
    env = TurnsEnv(max_steps=48, header=header)
    gen = torch.Generator(device=device).manual_seed(seed)
    _, states = env.reset(n, gen)
    states = states.replace(step_count=randint(gen, n, 0, states.max_steps))
    cache = env.batch_reset_cache(n, r, gen)
    actions = torch.randint(0, env.num_actions, (steps, n), generator=gen, device=device, dtype=torch.int32)
    return env, gen, states, cache, actions


def _assert_k1_equals_plain(env, states, cache, actions, compute_obs):
    before = fr.KERNEL_LAUNCHES
    got = fr.fused_rollout_core(env, states, cache, actions, compute_obs)
    torch.cuda.synchronize()
    assert fr.KERNEL_LAUNCHES == before + 1
    want = fr.fused_rollout_reference(env, states, cache, actions, compute_obs)
    for f in FIELDS:
        assert torch.equal(getattr(got[0], f), getattr(want[0], f)), f
    _assert_extra_same(got[0].extra, want[0].extra)
    assert [int(x) for x in got[2:]] == [int(x) for x in want[2:]]
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-6)
    return got


@pytest.mark.parametrize("compute_obs", [False, True])
def test_user_ext_k1_matches_plain_version(device, tmp_path, compute_obs):
    env, _, states, cache, actions = _turns_case(device, write_header(tmp_path), 4127)
    assert fused_eligible(env, device)
    got = _assert_k1_equals_plain(env, states, cache, actions, compute_obs)
    assert int(got[2]) >= 4127 and int(got[4]) >= 1
    assert _build.library_path("fused_rollout", env.fused_ext.kernel_source, "TurnsExt").exists()


def test_user_ext_k2_meets_the_contracts(device, tmp_path):
    env, gen, states, cache, _ = _turns_case(device, write_header(tmp_path), 4128)
    weights = _biased_actor(env, gen, device)
    noise = ar.draw_bits(gen, (64, env.num_actions, 4128), device)
    before = ar.KERNEL_LAUNCHES
    final, traj = ar.fused_actor_rollout_core(env, weights, states, cache, noise)
    torch.cuda.synchronize()
    assert ar.KERNEL_LAUNCHES == before + 1
    assert int(traj["done"].sum()) >= 4128
    ar.check_trajectory(env, weights, states, cache, noise, final, traj, ar.PLAIN_ATOL)


def test_user_ext_header_that_fails_to_compile_raises(device, tmp_path):
    broken = TURNS_HEADER.replace("x.turns + 1 : 0;", "x.turns + 1 : 0")
    env, _, states, cache, actions = _turns_case(device, write_header(tmp_path, broken), 64)
    before = fr.KERNEL_LAUNCHES
    with pytest.raises(RuntimeError, match="nvcc failed") as caught:
        fr.fused_rollout_core(env, states, cache, actions, False)
    assert "error" in str(caught.value) and "turns.cuh" in str(caught.value)
    assert fr.KERNEL_LAUNCHES == before


def test_user_ext_edited_header_is_rebuilt(device, tmp_path):
    header = write_header(tmp_path)
    env, _, states, cache, actions = _turns_case(device, header, 1024)
    first = _build.library_path("fused_rollout", header, "TurnsExt")
    _assert_k1_equals_plain(env, states, cache, actions, False)
    # Five turns in a row now: in a new process (this one's loaded
    # libraries forgotten) the kernel of the edited header agrees with a
    # twin that waits for five, so it was rebuilt, not reused.
    write_header(tmp_path, TURNS_HEADER.replace(">= 4;", ">= 5;  // five in a row"))
    env.fused_ext.max_turns = 5
    second = _build.library_path("fused_rollout", header, "TurnsExt")
    assert second != first and not second.exists()
    for key in [k for k in _build._LIBS if isinstance(k, tuple)]:
        del _build._LIBS[key]
    got = _assert_k1_equals_plain(env, states, cache, actions, False)
    assert second.exists() and int(got[0].extra["turns"].max()) <= 4
    assert _build.library_path("fused_rollout") != second


def test_user_ext_twin_must_declare_what_its_header_does(device, tmp_path):
    env, gen, states, cache, actions = _turns_case(device, write_header(tmp_path), 64)
    env.fused_ext.kernel_switches = (True, True, None)  # the header fixes SEE_THROUGH to 0
    assert fused_eligible(env, device)
    with pytest.raises(ValueError, match="declares MAX_K, NUM_PLANES, SWITCHES"):
        fr.fused_rollout_core(env, states, cache, actions, False)
    weights = _biased_actor(env, gen, device)
    noise = ar.draw_bits(gen, (64, env.num_actions, 64), device)
    with pytest.raises(ValueError, match="declares MAX_K, NUM_PLANES, SWITCHES"):
        ar.fused_actor_rollout_core(env, weights, states, cache, noise)


# -- a counter-reset family written outside the package (phase 36's TargetBall) --


def _target_case(device, header, n, steps=64, seed=23):
    env = TargetBallEnv(max_steps=40, header=header)
    gen = torch.Generator(device=device).manual_seed(seed)
    _, states = env.reset(n, gen)
    states = states.replace(step_count=randint(gen, n, 0, states.max_steps))
    seeds = torch.randint(-(2**31), 2**31, (n, 2), generator=gen, device=device, dtype=torch.int32)
    actions = torch.randint(0, env.num_actions, (steps, n), generator=gen, device=device, dtype=torch.int32)
    return env, gen, states, seeds, actions


@pytest.mark.parametrize("compute_obs", [False, True])
def test_user_counter_reset_k1_matches_plain_version(device, tmp_path, compute_obs):
    # The owner-lane reset writes the grid, contents, mission, target and
    # plane; N = 4127 leaves a warp partly past N.
    env, _, states, seeds, actions = _target_case(device, write_target_header(tmp_path), 4127)
    assert fused_eligible(env, device)
    before = fr.KERNEL_LAUNCHES
    got = fr.fused_rollout_core(env, states, None, actions, compute_obs, seeds)
    torch.cuda.synchronize()
    assert fr.KERNEL_LAUNCHES == before + 1
    want = fr.fused_rollout_reference(env, states, None, actions, compute_obs, seeds)
    for f in FIELDS:
        assert torch.equal(getattr(got[0], f), getattr(want[0], f)), f
    _assert_extra_same(got[0].extra, want[0].extra)
    assert [int(x) for x in got[2:]] == [int(x) for x in want[2:]]
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-5)
    assert int(got[2]) > 4127 and int(got[4]) == 0 and float(got[1]) > 0


def test_user_counter_reset_k2_meets_the_contracts(device, tmp_path):
    # The per-lane reset at stride N, in the actor kernel's env-minor columns.
    env, gen, states, seeds, _ = _target_case(device, write_target_header(tmp_path), 4128)
    weights = _biased_actor(env, gen, device)
    noise = ar.draw_bits(gen, (64, env.num_actions, 4128), device)
    before = ar.KERNEL_LAUNCHES
    final, traj = ar.fused_actor_rollout_core(env, weights, states, None, noise, seeds)
    torch.cuda.synchronize()
    assert ar.KERNEL_LAUNCHES == before + 1
    assert int(traj["done"].sum()) > 4128
    ar.check_trajectory(env, weights, states, None, noise, final, traj, ar.PLAIN_ATOL, reset_seeds=seeds)


def test_user_counter_reset_header_with_a_broken_reset_raises(device, tmp_path):
    broken = TARGET_HEADER.replace("rc.cont[b * N] = OBJ_BALL | (cb << 8);", "rc.cont[b * N] = OBJ_BALL | (cb << 8)")
    assert broken != TARGET_HEADER
    env, _, states, seeds, actions = _target_case(device, write_target_header(tmp_path, broken), 64)
    before = fr.KERNEL_LAUNCHES
    with pytest.raises(RuntimeError, match="nvcc failed") as caught:
        fr.fused_rollout_core(env, states, None, actions, False, seeds)
    assert "error" in str(caught.value) and "target_ball.cuh" in str(caught.value)
    assert fr.KERNEL_LAUNCHES == before
