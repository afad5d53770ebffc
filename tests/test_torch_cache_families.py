"""The reset-cache families (DoorKey, FourRooms, GoToObject, GoToDoor, Fetch,
and the classic zoo's last slice) through the port's whole-rollout op, step
hooks and cached stepper.

* The plain version of the rollout kernel against the JAX package's Pallas
  kernel in interpret mode, on JAX's states and R=2 reset cache (``extra``
  included) carried across by ``utils/bridge.py``: the final state with its
  ``extra``, ``used``, the done count, the checksum and ``max_used`` bit
  for bit, the reward total to rtol 1e-6 (XLA's FMA, ROADMAP queue 3).
* The step overlays of GoToObject, GoToDoor, Fetch, Memory, PutNear and
  RedBlueDoors against the original
  Minigrid's recorded transitions (``tests/golden/overlay_*.npz``), through
  ``step_env`` with the recorded target in ``extra`` (``utils/golden.py``).
* The cached stepper against the JAX package's ``step_cached`` on the same
  cache, and the plain learner collector reading that cache.
* The gates: an ext with extra planes and no compiled twin, and a cached
  ext without its cache scalars, raise; every compiled ext's ``kernel_id`` and
  ``kernel_switches`` are its CUDA twin's (``csrc/exts.cuh``, ``SWITCHES``).
"""

from __future__ import annotations

import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minigrid_tpu as mg
import minigrid_tpu_torch as mgt
from minigrid_tpu.ops.fused_rollout import fused_rollout_core as j_fused_rollout_core
from minigrid_tpu_torch.core.state import FIELDS
from minigrid_tpu_torch.ops import actor_rollout as ar
from minigrid_tpu_torch.ops import fused_ext as fx
from minigrid_tpu_torch.ops import fused_rollout as fr
from minigrid_tpu_torch.parallel.reset_budget import pool_size
from minigrid_tpu_torch.parallel.vector import fused_eligible, make_cached_stepper, rollout_capacity
from minigrid_tpu_torch.rl.model import ActorCritic
from minigrid_tpu_torch.rl.rollout import collect_trajectory
from minigrid_tpu_torch.utils import golden
from torch_port_util import assert_states_equal, to_jax, to_port

N, R = 1024, 2
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
# The classic zoo's last slice, one id a family.
ZOO_CACHE_IDS = [
    "MiniGrid-Unlock-v0",
    "MiniGrid-BlockedUnlockPickup-v0",
    "MiniGrid-KeyCorridorS3R1-v0",
    "MiniGrid-ObstructedMaze-1Dlhb-v0",
    "MiniGrid-DistShift1-v0",
    "MiniGrid-LavaGapS5-v0",
    "MiniGrid-MemoryS7-v0",
    "MiniGrid-PutNear-6x6-N2-v0",
    "MiniGrid-RedBlueDoors-6x6-v0",
    "MiniGrid-LockedRoom-v0",
    "MiniGrid-Playground-v0",
    "MiniGrid-MultiRoom-N2-S4-v0",
]
CACHE_IDS = [
    "MiniGrid-DoorKey-5x5-v0",
    "MiniGrid-FourRooms-v0",
    "MiniGrid-Fetch-5x5-N2-v0",
    "MiniGrid-GoToObject-6x6-N2-v0",
    "MiniGrid-GoToDoor-5x5-v0",
    *ZOO_CACHE_IDS,
]
# R at 256 steps: the measured maximum plus 25% and at least 2.
COVERING_R_256 = {
    "MiniGrid-DoorKey-5x5-v0": 10,  # no row: the fallback of 8
    "MiniGrid-FourRooms-v0": 8,  # 6, measured over 32 chunks (JAX's row: 5)
    "MiniGrid-Fetch-5x5-N2-v0": 22,  # 17
    "MiniGrid-GoToObject-6x6-N2-v0": 134,  # 107
    "MiniGrid-GoToDoor-5x5-v0": 132,  # 105
    "MiniGrid-Unlock-v0": 6,  # 4
    "MiniGrid-BlockedUnlockPickup-v0": 4,  # 2
    "MiniGrid-KeyCorridorS3R1-v0": 10,  # no row: the fallback of 8
    "MiniGrid-ObstructedMaze-1Dlhb-v0": 10,  # no row: the fallback of 8
    "MiniGrid-DistShift1-v0": 1,  # deterministic_generation
    "MiniGrid-LavaGapS5-v0": 10,  # no row: the fallback of 8
    "MiniGrid-MemoryS7-v0": 10,  # no row: the fallback of 8
    "MiniGrid-PutNear-6x6-N2-v0": 10,  # no row: the fallback of 8
    "MiniGrid-RedBlueDoors-6x6-v0": 10,  # no row: the fallback of 8
    "MiniGrid-LockedRoom-v0": 4,  # 2
    "MiniGrid-Playground-v0": 5,  # 3
    "MiniGrid-MultiRoom-N2-S4-v0": 10,  # no row: the fallback of 8
}
# (env id, make kwargs, steps, seed): tests/test_fused_rollout.py's cases.
K1_CASES = {
    # Keys, the locked door, occlusion; the default 250 steps.
    "doorkey5x5": ("MiniGrid-DoorKey-5x5-v0", {}, 12, 3),
    # 19x19, beyond the view; truncation resets through the cache.
    "fourrooms": ("MiniGrid-FourRooms-v0", {"max_steps": 5}, 6, 5),
    # Any pickup ends the episode; the target blended from the cache.
    "fetch5x5n2": ("MiniGrid-Fetch-5x5-N2-v0", {"max_steps": 8}, 12, 7),
    # done/toggle end episodes; target_pos blended from the cache.
    "gotoobject6x6n2": ("MiniGrid-GoToObject-6x6-N2-v0", {"max_steps": 8}, 12, 2),
    "gotodoor5x5": ("MiniGrid-GoToDoor-5x5-v0", {"max_steps": 8}, 12, 4),
    # Keys boxed in the contents plane; success is a pickup of the blue ball.
    "obstructedmaze2dlh": ("MiniGrid-ObstructedMaze-2Dlh-v0", {"max_steps": 8}, 12, 9),
    # Both doors read before and after the step (FRONT_BEFORE in the kernels).
    "redbluedoors6x6": ("MiniGrid-RedBlueDoors-6x6-v0", {"max_steps": 8}, 12, 10),
}


ZOO_K1_IDS = ("MiniGrid-ObstructedMaze-2Dlh-v0", "MiniGrid-RedBlueDoors-6x6-v0")


@pytest.mark.parametrize("case", list(K1_CASES))
def test_rollout_plain_version_matches_jax_kernel(case):
    env_id, kwargs, steps, seed = K1_CASES[case]
    jenv, tenv = mg.make(env_id, **kwargs), mgt.make(env_id, **kwargs)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    if env_id in ZOO_K1_IDS:
        # The port's levels, as in the cached stepper's test.
        gen = torch.Generator().manual_seed(seed)
        jstates, jcache = to_jax(tenv.reset(N, gen)[1]), to_jax(tenv.batch_reset_cache(N, R, gen))
    else:
        _, jstates = jax.jit(jax.vmap(jenv.reset))(jax.random.split(k1, N))
        jcache = jenv.batch_reset_cache(k2, N, R)
    actions = jax.random.randint(k3, (steps, N), 0, jenv.num_actions, jnp.int32)
    jfinal, jrew, jdone, jchk, jused = j_fused_rollout_core(jenv, jstates, jcache, actions, True, True)  # interpret
    before = fr.KERNEL_LAUNCHES
    final, rew, done, chk, used = fr.fused_rollout_core(
        tenv, to_port(jstates), to_port(jcache), torch.from_numpy(np.array(actions)), True
    )
    assert fr.KERNEL_LAUNCHES == before  # CPU tensors: the plain version
    assert_states_equal(final, jfinal, case)  # extra included
    assert int(done) == int(jdone)
    assert int(chk) == int(jchk)
    assert int(used) == int(jused)
    np.testing.assert_allclose(float(rew), float(jrew), rtol=1e-6)
    if case != "doorkey5x5":
        # Every env ends an episode and resets from its cache.
        assert int(done) >= N and int(used) >= 1


OVERLAY_IDS = [
    "MiniGrid-Fetch-8x8-N3-v0",
    "MiniGrid-GoToDoor-8x8-v0",
    "MiniGrid-GoToObject-8x8-N2-v0",
    "MiniGrid-MemoryS13-v0",
    "MiniGrid-PutNear-8x8-N3-v0",
    "MiniGrid-RedBlueDoors-8x8-v0",
]


@pytest.mark.parametrize("env_id", OVERLAY_IDS)
def test_step_overlay_matches_the_reference(env_id):
    path = os.path.join(GOLDEN_DIR, f"overlay_{env_id}.npz")
    assert golden.replay(path, "cpu", mgt.make(env_id)) >= 800


@pytest.mark.parametrize("env_id", CACHE_IDS)
def test_cached_stepper_matches_jax_step_cached(env_id):
    jenv, tenv = mg.make(env_id, max_steps=6), mgt.make(env_id, max_steps=6)
    n, steps = 128, 14
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(8), 3)
    if env_id in ZOO_CACHE_IDS:
        # Levels from the port's generators (test_torch_generators.py holds
        # them to JAX's), which spares compiling JAX's RoomGrid and maze
        # generators; the stepper is what this test holds.
        gen = torch.Generator().manual_seed(8)
        jst, jcache = to_jax(tenv.reset(n, gen)[1]), to_jax(tenv.batch_reset_cache(n, 3, gen))
    else:
        _, jst = jax.jit(jax.vmap(jenv.reset))(jax.random.split(k1, n))
        jcache = jenv.batch_reset_cache(k2, n, 3)
    actions = np.asarray(jax.random.randint(k3, (steps, n), 0, 7, jnp.int32))
    jstep = jax.jit(jax.vmap(jenv.step_cached, in_axes=(0, 0, 0, 0)))
    step = make_cached_stepper(tenv, to_port(jcache), n)
    st, jused = to_port(jst), jnp.zeros(n, jnp.int32)
    used = torch.zeros(n, dtype=torch.int32)
    for t in range(steps):
        _, jst, jr, jterm, jtrunc, jused = jstep(jst, jnp.asarray(actions[t]), jcache, jused)
        st, r, term, trunc, used = step(st, torch.from_numpy(actions[t].copy()), used)
        assert_states_equal(st, jst, f"{env_id} step {t}")
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-6, atol=0)
        np.testing.assert_array_equal(term.numpy(), np.asarray(jterm))
        np.testing.assert_array_equal(trunc.numpy(), np.asarray(jtrunc))
        np.testing.assert_array_equal(used.numpy(), np.asarray(jused))
    # Every env reset twice or more: the blend reached past slot 0.
    assert int(used.min()) >= 2


def test_plain_collector_reads_the_cache():
    # The plain collector of an expensive_reset family draws its reset
    # cache from the generator before the first step, then the bits of
    # each step; replaying its actions through the cached stepper on that
    # cache gives its trajectory.
    env = mgt.make("MiniGrid-GoToDoor-5x5-v0", max_steps=6)
    n, steps, resets = 64, 12, 3
    gen = torch.Generator().manual_seed(4)
    model = ActorCritic(32, env.num_actions, generator=gen)
    _, states = env.reset(n, gen)
    snapshot = gen.get_state()
    final, traj = collect_trajectory(env, model, states, gen, steps, resets)
    gen.set_state(snapshot)
    cache = env.batch_reset_cache(n, resets, gen)
    step = make_cached_stepper(env, cache, n)
    st, used = states, torch.zeros(n, dtype=torch.int32)
    for t in range(steps):
        assert torch.equal(env.observation_packed(st), traj.obs[t]), t
        st, reward, term, trunc, used = step(st, traj.action[t], used)
        assert torch.equal(reward, traj.reward[t]) and torch.equal(term | trunc, traj.done[t]), t
    for f in FIELDS:
        assert torch.equal(getattr(st, f), getattr(final, f)), f
    assert torch.equal(st.extra["target_pos"], final.extra["target_pos"])
    assert int(traj.done.sum()) > n  # episodes ended and reset from the cache


@pytest.mark.parametrize("env_id", CACHE_IDS)
def test_cache_families_take_the_kernels_on_cuda_and_the_plain_loop_on_cpu(env_id):
    env = mgt.make(env_id)
    assert fr.supports_fused(env) and fr.compiled_ext(env) and not fr.counter_reset(env)
    assert fused_eligible(env, "cuda") and not fused_eligible(env, "cpu")
    assert ar.supports_fused_actor(env, "cuda", 1024, 64)
    # The measured rows of parallel/reset_budget.py (the port's FourRooms
    # correction, its own GoTo and Fetch rows), else its fallback (DoorKey-5x5).
    assert rollout_capacity(env, 256, "cuda") == COVERING_R_256[env_id]
    # The plain path: the shared pool for an expensive_reset family.
    want = pool_size(env, 256, N) if env.expensive_reset else 0
    assert rollout_capacity(env, 256, "cpu", num_envs=N) == want


def test_fused_rollout_draws_actions_then_the_cache_with_its_extra():
    env = mgt.make("MiniGrid-Fetch-5x5-N2-v0", max_steps=10)
    n, steps = 256, 24
    gen = torch.Generator().manual_seed(3)
    _, states = env.reset(n, gen)
    snapshot = gen.get_state()
    out = fr.fused_rollout(env, states, gen, steps, 3, compute_obs=True)
    gen.set_state(snapshot)
    actions = torch.randint(0, env.num_actions, (steps, n), generator=gen, dtype=torch.int32)
    cache = env.batch_reset_cache(n, 3, gen)
    assert set(cache.extra) == {"target_type", "target_color"} and cache.extra["target_type"].shape == (n, 3)
    ref = fr.fused_rollout_core(env, states, cache, actions, True)
    for f in FIELDS:
        assert torch.equal(getattr(out[0], f), getattr(ref[0], f)), f
    for k, v in ref[0].extra.items():
        assert torch.equal(out[0].extra[k], v), k
    assert [float(x) for x in out[1:]] == [float(x) for x in ref[1:]]
    assert int(out[4]) >= 3  # past the last slot


class _PlanesExt(fx.CachedExt):
    """An ext with one extra plane per env, as BabyAI's has, but no compiled
    twin to carry it."""

    n_scalars = 0
    n_planes = 1
    kernel_id = None


def test_gates_refuse_planes_and_a_cache_without_its_scalars():
    env = mgt.make("MiniGrid-GoToDoor-5x5-v0", max_steps=6)
    gen = torch.Generator().manual_seed(1)
    _, states = env.reset(32, gen)
    cache = env.batch_reset_cache(32, 2, gen)
    actions = torch.randint(0, 7, (4, 32), generator=gen, dtype=torch.int32)
    noise = ar.draw_bits(gen, (4, 7, 32), None)
    weights = ar.repack_actor_params(ActorCritic(64, 7, generator=gen))
    bare = cache.replace(extra=None)
    with pytest.raises(ValueError, match="must both carry them"):
        fr.fused_rollout_core(env, states, bare, actions)
    with pytest.raises(ValueError, match="must both carry them"):
        ar.fused_actor_rollout_core(env, weights, states, bare, noise)
    planes = mgt.make("MiniGrid-GoToDoor-5x5-v0")
    planes.fused_ext = _PlanesExt()
    assert not fr.compiled_ext(planes) and not fused_eligible(planes, "cuda")
    with pytest.raises(ValueError, match="P planes"):
        fr.fused_rollout_core(planes, states, cache, actions)
    with pytest.raises(ValueError, match="P planes"):
        ar.fused_actor_rollout_core(planes, weights, states, cache, noise)
    # A cached ext compiled for see-through walls only.
    opaque = mgt.make("MiniGrid-GoToDoor-5x5-v0")
    opaque.see_through_walls = False
    assert not fr.compiled_ext(opaque)


CSRC = Path(fr.__file__).resolve().parent / "csrc"


@pytest.mark.parametrize(
    "env_id, header",
    [
        ("MiniGrid-Empty-Random-5x5-v0", "empty_random"),
        ("MiniGrid-LavaCrossingS9N2-v0", "crossing"),
        ("MiniGrid-Dynamic-Obstacles-8x8-v0", "dynamic_obstacles"),
        ("MiniGrid-GoToDoor-8x8-v0", "goto_target"),
        ("MiniGrid-Fetch-8x8-N3-v0", "fetch"),
        ("MiniGrid-Unlock-v0", "unlock"),
        ("MiniGrid-KeyCorridorS3R3-v0", "pickup_target"),
        ("MiniGrid-ObstructedMaze-2Dlh-v0", "obstructed_maze"),
        ("MiniGrid-MemoryS17Random-v0", "memory"),
        ("MiniGrid-PutNear-8x8-N3-v0", "put_near"),
        ("MiniGrid-RedBlueDoors-8x8-v0", "red_blue_doors"),
    ],
)
def test_ext_twins_declare_their_cuda_ids_and_switches(env_id, header):
    """The Python twin names the struct that ``ext/<header>.cuh`` defines
    (``exts.cuh`` maps the id to it) and the switches it is instantiated at."""
    ext = mgt.make(env_id).fused_ext
    source = (CSRC / "ext" / f"{header}.cuh").read_text()
    struct = re.search(r"struct (\w+) : NoExt", source).group(1)
    ids = dict(re.findall(r"(EXT_\w+) = (\d+)", (CSRC / "fused_ext.cuh").read_text()))
    # A library of one shape holds one built-in ext: ``if constexpr
    # (holds_ext(EXT_...))`` guards each call.
    cases = dict(
        re.findall(
            r"case (EXT_\w+):\s+(?:if constexpr \(holds_ext\(\1\)\) )?f\((\w+)\{\}\)", (CSRC / "exts.cuh").read_text()
        )
    )
    assert {int(ids[name]) for name, s in cases.items() if s == struct} == {ext.kernel_id}
    declared = re.search(r"SWITCHES\[3\] = \{([^}]*)\}", source).group(1).split(",")
    value = {"1": True, "0": False, "SWITCH_ANY": None}
    assert tuple(value[w.strip()] for w in declared) == ext.kernel_switches
    assert fr.compiled_ext(mgt.make(env_id))
