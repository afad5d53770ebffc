"""The port at the view sizes and hidden widths beyond the built-in
libraries' (view 7, widths 64 and 256), against the JAX package's plain
paths on the CPU.

On the card the rollout kernels take every odd view from 3 to 31 and the
actor kernel every multiple of 32 from 32 to 512, each shape outside the
built-in libraries built at its first launch for the family that launches
it (``ops/_build.Shape``); the embed + dense-1 kernels take those widths at
run time.  Here each plain version runs at such shapes and is held to the
JAX package: the PPO update at widths 96 and 128 and at view 5, the
random-policy rollout's observation checksum at views 3 to 31, the first
layer at 96 and 384.  The gates' rules, the actor weights' two-pass layout
and the shape libraries' keys need no card and no ``nvcc``.  Every JAX
side here is its plain path (no interpreted Pallas kernel), so each case
takes seconds.
"""

from __future__ import annotations

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minigrid_tpu as mg
import minigrid_tpu_torch as mgt
from minigrid_tpu.core.obs import gen_obs_packed as jax_gen_obs_packed
from minigrid_tpu.rl import model as jmodel
from minigrid_tpu.rl import ppo as jppo
from minigrid_tpu_torch.core import obs as obs_lib
from minigrid_tpu_torch.core.env import MiniGridEnv
from minigrid_tpu_torch.ops import _build
from minigrid_tpu_torch.ops import actor_rollout as ar
from minigrid_tpu_torch.ops import embed_dense as ed
from minigrid_tpu_torch.ops import fused_rollout as fr
from minigrid_tpu_torch.parallel.vector import fused_eligible
from minigrid_tpu_torch.rl import ppo as tppo
from minigrid_tpu_torch.rl.model import ActorCritic
from minigrid_tpu_torch.rl.rollout import Trajectory
from minigrid_tpu_torch.tools import roofline
from minigrid_tpu_torch.utils.bridge import params_from_flax, state_from_numpy
from minigrid_tpu_torch.utils.synthetic import random_states
from torch_port_util import jax_learner_init, jax_state, observations, to_port, with_bias_noise

# (hidden, view): two widths between the built-in ones at the built-in
# view, and a narrower view at the narrowest width.
LEARNER_SHAPES = [(96, 7), (128, 7), (32, 5)]
VIEWS = [3, 5, 9, 17, 31]


@pytest.fixture(scope="module", params=LEARNER_SHAPES, ids=lambda s: f"h{s[0]}v{s[1]}")
def jax_batch(request):
    """A JAX learner's trajectory on Empty-5x5 at this width and view (64
    envs x 16 steps, nonzero biases), the behaviour logp moved off the
    policy so that the clipped ratio is exercised, and its update's metrics
    (one minibatch)."""
    hidden, view = request.param
    config = jppo.PPOConfig(rollout_steps=16, num_minibatches=1)
    init_fn, step = jppo.make_ppo(mg.make("MiniGrid-Empty-5x5-v0", agent_view_size=view), config, hidden=hidden)
    state = jax_learner_init(init_fn, jax.random.PRNGKey(0), 64)
    state = state._replace(params=jax.tree.map(jnp.asarray, with_bias_noise(jax.tree.map(np.array, state.params), 0)))
    env_states, key, traj = step.rollout(state.params, state.env_states, state.key)
    shift = np.random.default_rng(1).normal(0, 0.3, traj.logp.shape).astype(np.float32)
    traj = traj._replace(logp=traj.logp + shift)
    _, _, _, metrics = step.update(state.params, state.opt_state, key, env_states, traj)
    return hidden, view, config, jax.tree.map(np.array, state.params), env_states, traj, metrics


def test_ppo_update_matches_jax_at_other_shapes(jax_batch):
    hidden, view, config, params, env_states, traj, want = jax_batch
    assert traj.obs.shape[-1] == view * view
    model = ActorCritic(hidden, 7, view, device="cpu")
    model.load_state_dict(params_from_flax(params))
    env = mgt.make("MiniGrid-Empty-5x5-v0", agent_view_size=view)
    _, step = tppo.make_ppo(env, tppo.PPOConfig(**config._asdict()), hidden=hidden)
    port_traj = Trajectory(*(torch.from_numpy(np.array(x)) for x in traj))
    before = dict(ed.KERNEL_LAUNCHES)
    _, opt_state, got = step.update(model, tppo.adam_init(model), to_port(env_states), port_traj)
    assert opt_state.count == 1 and ed.KERNEL_LAUNCHES == before  # the CPU: plain versions
    for k in ("pg_loss", "value_loss", "entropy"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-3, err_msg=k)
    for k in ("reward_per_step", "episodes"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("see_through", [False, True])
@pytest.mark.parametrize("view", VIEWS)
def test_rollout_checksum_matches_jax_observation(view, see_through):
    # One step of turning left on object-rich 13x11 states (doors, keys,
    # boxes, carried objects, occlusion): the plain rollout's observation
    # checksum is the sum of JAX's packed observation of the turned states,
    # whose cells the port's plain observation gives bit for bit.
    rng = np.random.default_rng(view)
    n, w, h = 32, 13, 11
    arrays = random_states(rng, (n,), w, h, max_steps=(1000, 1001))
    arrays["step_count"] %= 500  # no truncation at the step
    arrays["terminated"][:] = False
    arrays["truncated"][:] = False
    env = MiniGridEnv(w, h, max_steps=1000, see_through_walls=see_through, agent_view_size=view)
    states = state_from_numpy(arrays, "cpu")
    cache = state_from_numpy(random_states(rng, (n, 1), w, h, fresh=True), "cpu")
    actions = torch.zeros((1, n), dtype=torch.int32)
    final, _, done, checksum, _ = fr.fused_rollout_reference(env, states, cache, actions, True)
    assert int(done) == 0

    turned = dict(arrays, agent_dir=(arrays["agent_dir"] + 3) % 4)
    want = np.asarray(jax.vmap(lambda s: jax_gen_obs_packed(s, view, see_through))(jax_state(turned)))
    got = obs_lib.gen_obs_packed(final, view, see_through, plain=True)
    np.testing.assert_array_equal(got.numpy(), want)
    total = int(want.astype(np.int64).sum())
    assert int(checksum) == (total + 2**31) % 2**32 - 2**31
    if not see_through:
        assert bool((got == 0).any()), "no occluded cell: the flood was not exercised"


@pytest.mark.parametrize("hidden", [96, 384])
def test_first_layer_matches_jax_at_other_widths(hidden):
    packed, direction = observations(64, seed=hidden)
    rng = np.random.default_rng(hidden)
    kernel = rng.normal(0, 0.05, (packed.shape[1] * 20 + 4, hidden)).astype(np.float32)
    bias = rng.normal(0, 0.1, hidden).astype(np.float32)
    x = jmodel.embed_obs_packed(jnp.asarray(packed), jnp.asarray(direction)).astype(jnp.bfloat16)
    dense = nn.Dense(hidden, dtype=jnp.bfloat16)
    want = dense.apply({"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}, x)
    got = ed.embed_dense1_reference(
        torch.from_numpy(kernel), torch.from_numpy(bias), torch.from_numpy(packed), torch.from_numpy(direction)
    )
    assert got.dtype == torch.bfloat16 and got.shape == (packed.shape[0], hidden)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=0, atol=2e-2)


class _Env:
    def __init__(self, view=7, width=8, height=8, num_actions=7):
        self.agent_view_size, self.width, self.height, self.num_actions = view, width, height, num_actions


def test_the_gates_take_every_width_and_view_the_jax_kernels_take():
    for hidden in range(32, 513, 32):
        assert ar.shape_refusal(_Env(), 64, hidden) is None, hidden
        assert ed.hidden_ok(hidden), hidden
    for view in range(3, 32, 2):
        assert fr.view_refusal(view) is None, view
        assert ar.shape_refusal(_Env(view), 64, 64) is None, view
    for hidden in (16, 100, 544, 1024):
        assert f"hidden size {hidden}" in ar.shape_refusal(_Env(), 64, hidden)
    assert "view size 33" in fr.view_refusal(33) and "view size 33" in ar.shape_refusal(_Env(33), 64, 64)
    assert "650 grid cells" in ar.shape_refusal(_Env(width=26, height=25), 64, 64)
    assert not ed.hidden_ok(100) and not ed.hidden_ok(544)
    assert [ed.backward_width(h) for h in (32, 64, 96, 160, 448, 512)] == [64, 64, 128, 192, 448, 512]


@pytest.mark.parametrize("view", [5, 9, 31])
def test_rollout_random_takes_the_kernel_at_any_view(view):
    # The view no longer gates the kernel (the JAX package's does not
    # either): on the card fused="auto" launches it; here the CPU takes the
    # plain loop.
    env = mgt.make("MiniGrid-DoorKey-8x8-v0", agent_view_size=view)
    assert fused_eligible(env, "cuda") and not fused_eligible(env, "cpu")
    # A wider view still reaches the kernel, which raises, naming it.
    assert fused_eligible(mgt.make("MiniGrid-Empty-8x8-v0", agent_view_size=33), "cuda")


def test_shape_libraries_are_keyed_by_shape_and_family():
    builtin = _build.library_path("actor_rollout")
    h128 = _build.library_path("actor_rollout", shape=_build.Shape(7, 128, 0, (0, 0, 0)))
    assert h128.name.startswith("actor_rollout-v7-h128-") and h128 != builtin
    assert _build.library_path("actor_rollout", shape=_build.Shape(7, 128, 0, (0, 0, 0))) == h128  # stable
    assert _build.library_path("actor_rollout", shape=_build.Shape(7, 128, 3, (0, 0, 0))) != h128  # another family's ext
    v5 = _build.library_path("fused_rollout", shape=_build.Shape(5, 0, 0, (0, 0, 0)))
    assert v5.name.startswith("fused_rollout-v5-") and "-h" not in v5.name
    assert _build.Shape(5, 128, 3, (0, 1, 0)).flags() == (
        "-DMINIGRID_VIEW=5", "-DMINIGRID_HIDDEN=128", "-DMINIGRID_ONLY_EXT=3",
        "-DMINIGRID_NO_OBJECTS=0", "-DMINIGRID_STATIC_MISSION=1", "-DMINIGRID_SEE_THROUGH=0",
    )
    assert _build.shape_key("actor_rollout", _build.Shape(5, 128, 3, (1, 1, 0))) == "actor_rollout-v5-h128[ext 3, switches 110]"
    # Which library a family's launch takes.
    doorkey = mgt.make("MiniGrid-DoorKey-8x8-v0")
    assert fr.kernel_shape("fused_rollout", doorkey) is None
    assert fr.kernel_shape("actor_rollout", doorkey, 256) is None and fr.kernel_shape("actor_rollout", doorkey, 64) is None
    assert fr.kernel_flags(doorkey) == (0, 0, 0)  # objects, a per-episode mission, occluding walls
    assert fr.kernel_shape("actor_rollout", doorkey, 128) == _build.Shape(7, 128, 0, (0, 0, 0))
    obstacles = mgt.make("MiniGrid-Dynamic-Obstacles-8x8-v0", agent_view_size=5)
    kid, flags = obstacles.fused_ext.kernel_id, fr.kernel_flags(obstacles)
    assert fr.kernel_shape("fused_rollout", obstacles) == _build.Shape(5, 0, kid, flags)
    assert fr.kernel_shape("actor_rollout", obstacles, 64) == _build.Shape(5, 64, kid, flags)
    assert _build.Shape(5, 64, kid, (1, 1, 0)).flags()[-3:] == (
        "-DMINIGRID_NO_OBJECTS=1", "-DMINIGRID_STATIC_MISSION=1", "-DMINIGRID_SEE_THROUGH=0",
    )
    assert _build.library_path("fused_rollout", shape=_build.Shape(5, 0, 0, (0, 1, 0))) != _build.library_path(
        "fused_rollout", shape=_build.Shape(5, 0, 0, (1, 1, 0))
    )


def test_shape_library_is_built_once_with_its_defines(tmp_path, monkeypatch):
    # The build and the loader stubbed (no nvcc here).
    built = []

    def compile_(src, out, flags, info_key):
        built.append((src.name, out.name, info_key, [f for f in flags if f.startswith("-D")]))
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_bytes(b"")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_compile", compile_)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    shape = _build.Shape(31, 64, 0, (1, 1, 0))
    first = _build.load_library("actor_rollout", shape=shape)
    assert _build.load_library("actor_rollout", shape=shape) is first
    assert built == [(
        "actor_rollout.cu", first.split("/")[-1], "actor_rollout-v31-h64[ext 0, switches 110]",
        ["-DMINIGRID_VIEW=31", "-DMINIGRID_HIDDEN=64", "-DMINIGRID_ONLY_EXT=0", "-DMINIGRID_NO_OBJECTS=1",
         "-DMINIGRID_STATIC_MISSION=1", "-DMINIGRID_SEE_THROUGH=0"],
    )]
    assert _build.load_library("actor_rollout") != first and len(built) == 2


@pytest.mark.parametrize("hidden", [96, 512])
def test_tiled_weights_hold_w1_a_pass_at_a_time(hidden):
    # Above 256 layer 1 runs in two passes of hidden/4 columns a warpgroup:
    # each pass's K tiles, untiled, are W1's columns of that pass.
    rng = np.random.default_rng(hidden)
    f = 49 * 20 + 4
    bf16 = torch.bfloat16
    weights = ar.ActorWeights(
        torch.from_numpy(rng.normal(0, 0.05, (f, hidden)).astype(np.float32)).to(bf16), torch.zeros(hidden),
        torch.zeros((hidden, hidden), dtype=bf16), torch.zeros(hidden), torch.zeros((8, hidden), dtype=bf16),
        torch.zeros(8),
    )
    tiles = ar.tile_actor_weights(weights, 7)
    passes = ar.layer1_passes(hidden)
    assert passes == (2 if hidden > 256 else 1)
    kt = 2 * ar.onehot_words(7)
    assert tiles.w1.shape == (passes * kt, 2, hidden // passes // 8, 2, 8, 8)
    for index in range(passes):
        part = tiles.w1[index * kt : (index + 1) * kt]
        w1 = ar.untile_b(part[:, 0]).double() + ar.untile_b(part[:, 1]).double()
        cols = ar.pass_columns(hidden, index)
        assert torch.equal(w1[:f], weights.w1[:, cols].double()) and not w1[f:].any()
    assert sorted(torch.cat([ar.pass_columns(hidden, i) for i in range(passes)]).tolist()) == list(range(hidden))


@pytest.mark.parametrize(
    "view, hidden, want",
    [
        (7, 32, ("0.0789", "bytes")),
        (7, 96, ("0.2435", "operations")),
        (7, 128, ("0.3334", "operations")),
        (7, 512, ("1.7505", "operations")),
        (5, 64, ("0.0859", "operations")),
        (31, 64, ("2.8985", "operations")),
    ],
)
def test_actor_bound_at_other_shapes(view, hidden, want):
    # As tests/test_torch_profiler.py's hidden-256 figure (0.7363 ms):
    # Empty-8x8 at 8192 x 128, one level read an env.  Layer 1's 3 v*v + 1
    # row adds a width and layer 2's width^2 products grow with the shape;
    # at width 32 the bytes moved bound it.
    env = mgt.make("MiniGrid-Empty-8x8-v0", agent_view_size=view)
    gen = torch.Generator().manual_seed(0)
    _, states = env.reset(8192, gen, "cpu")
    weights = ar.repack_actor_params(ActorCritic(hidden, env.num_actions, view, gen, "cpu"))
    ms, by = roofline.actor_bound(env, states, weights, 128, 8192, 1)
    assert (f"{ms:.4f}", by) == want


@pytest.mark.parametrize(
    "hidden, want", [(32, ("0.0104", "bytes")), (96, ("0.0278", "operations")), (128, ("0.0371", "operations")),
                     (512, ("0.1482", "operations"))]
)
def test_embed_bound_at_other_widths(hidden, want):
    # A PPO minibatch (M = 131072, v = 7): the 148 f32 row adds a sample
    # scale with the width (0.0741 ms at 256), the same both ways.
    for direction in ("fwd", "bwd"):
        ms, by = roofline.embed_bound(131072, 49, hidden, direction)
        assert (f"{ms:.4f}", by) == want


def test_rollout_bound_at_other_views():
    # DoorKey-8x8 at 65536 x 64 (64 levels, each 1024 times), one level
    # read an env: the bytes moved do not depend on the view; the
    # observation checksum's v*v adds a step overtake them at view 31.
    for view in (3, 5, 9, 15, 17, 31):
        env = mgt.make("MiniGrid-DoorKey-8x8-v0", agent_view_size=view)
        _, states = env.reset(64, torch.Generator().manual_seed(0), "cpu")
        states = states.map(lambda x: x.repeat_interleave(1024, dim=0))
        ms, by = roofline.rollout_bound(env, states, 64, 1.0, compute_obs=True)
        assert (f"{ms:.5f}", by) == (("0.06016", "operations") if view == 31 else ("0.03913", "bytes"))
        assert roofline.rollout_bound(env, states, 64, 1.0) == (pytest.approx(0.03913, abs=5e-6), "bytes")
