"""The PyTorch port's whole-rollout op against the JAX package's fused kernel.

On the CPU the port's ``fused_rollout_core`` runs its plain version; the JAX
side runs the Pallas kernel in interpret mode, as tests/test_fused_rollout.py
does.  Both get the same states, actions and reset cache, or, for the
counter-reset families, reset seeds.  Integers (``extra`` included) must be
bit-exact; reward totals agree to rtol 1e-5, because they are summed in
another order.  The CUDA kernel itself is held against the plain version on
a GPU by tests/test_torch_cuda.py and ``chip_smoke.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minigrid_tpu as mg
import minigrid_tpu_torch as mgt
from minigrid_tpu.core.env import MiniGridEnv as JEnv
from minigrid_tpu.core.state import EnvState as JState
from minigrid_tpu.ops.fused_rollout import fused_rollout_core as j_fused_rollout_core
from minigrid_tpu_torch.core.env import MiniGridEnv
from minigrid_tpu_torch.core.state import FIELDS, tree_leaves
from minigrid_tpu_torch.ops import fused_rollout as fr
from minigrid_tpu_torch.parallel.reset_budget import pool_size
from minigrid_tpu_torch.parallel.vector import VectorEnv, fused_eligible, rollout_capacity, rollout_random
from minigrid_tpu_torch.utils.synthetic import random_states
from torch_port_util import assert_states_equal, to_port

N = 1024  # the JAX kernel's smallest block


def _jax_case(env_id, kwargs, r, seed):
    env = mg.make(env_id, **kwargs)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    _, states = jax.jit(jax.vmap(env.reset))(jax.random.split(k1, N))
    return env, states, env.batch_reset_cache(k2, N, r)


def _synthetic_case(seed):
    rng = np.random.default_rng(seed)
    w, h = 9, 7

    def jstate(arrays):
        keys = jnp.zeros(arrays["step_count"].shape + (2,), jnp.uint32)
        return JState(**{k: jnp.asarray(v) for k, v in arrays.items()}, rng=keys)

    s, c = random_states(rng, (N,), w, h), random_states(rng, (N, 2), w, h, fresh=True)
    return JEnv(w, h, max_steps=100, see_through_walls=False), jstate(s), jstate(c)


CASES = {
    # Truncation resets through an R=1 cache; the family's kernel switches.
    "empty8x8": lambda: _jax_case("MiniGrid-Empty-8x8-v0", {"max_steps": 7}, 1, 0),
    # Keys and doors, occlusion, R=2.
    "doorkey5x5": lambda: _jax_case("MiniGrid-DoorKey-5x5-v0", {"max_steps": 10}, 2, 3),
    # 19x19 grid, truncation resets.
    "fourrooms": lambda: _jax_case("MiniGrid-FourRooms-v0", {"max_steps": 5}, 2, 5),
    # Every object kind, carried objects, box contents, mission resets.
    "synthetic": lambda: _synthetic_case(9),
}


def _port_env(jenv, case):
    if case == "empty8x8":
        return mgt.make("MiniGrid-Empty-8x8-v0", max_steps=7)
    return MiniGridEnv(
        jenv.width, jenv.height, jenv.max_steps, jenv.see_through_walls, jenv.agent_view_size
    )


@pytest.mark.parametrize("case", list(CASES))
def test_fused_rollout_core_matches_jax_kernel(case):
    jenv, jstates, jcache = CASES[case]()
    steps = {"fourrooms": 6, "synthetic": 24}.get(case, 12)
    actions = np.random.default_rng(1).integers(0, 7, (steps, N), dtype=np.int32)
    jfinal, jrew, jdone, jchk, jused = j_fused_rollout_core(
        jenv, jstates, jcache, jnp.asarray(actions), True, True  # interpret=True
    )
    before = fr.KERNEL_LAUNCHES
    final, rew, done, chk, used = fr.fused_rollout_core(
        _port_env(jenv, case), to_port(jstates), to_port(jcache), torch.from_numpy(actions), True
    )
    assert fr.KERNEL_LAUNCHES == before  # CPU tensors: the plain version
    assert_states_equal(final, jfinal, case)
    assert (done.dtype, chk.dtype, used.dtype) == (torch.int32,) * 3
    assert int(done) == int(jdone) > 0
    assert int(chk) == int(jchk)
    assert int(used) == int(jused)
    np.testing.assert_allclose(float(rew), float(jrew), rtol=1e-5)


def test_checksum_wraps_like_int32():
    assert fr.wrap_int32(torch.tensor(2**31 + 5)).item() == -(2**31) + 5
    assert fr.wrap_int32(torch.tensor(-(2**31) - 1)).item() == 2**31 - 1
    assert fr.wrap_int32(torch.tensor(12345)).item() == 12345


def test_cpu_dispatch_takes_the_plain_path():
    env = mgt.make("MiniGrid-Empty-8x8-v0")
    before = fr.KERNEL_LAUNCHES
    assert not fused_eligible(env, "cpu")
    assert rollout_capacity(env, 256, "cpu") == 0
    gen = torch.Generator().manual_seed(0)
    _, states = VectorEnv(env, 64, "cpu").reset(gen)
    final, total_r, total_done, max_used = rollout_random(env, states, gen, 300)
    assert final.step_count.shape == (64,) and int(final.step_count.max()) < env.max_steps
    assert int(total_done) >= 64 and int(max_used) == 0 and torch.isfinite(total_r)
    assert fr.KERNEL_LAUNCHES == before


def test_fused_rollout_draws_actions_then_cache():
    # fused_rollout is fused_rollout_core on the actions and cache drawn from
    # the generator, in that order (what chip_smoke.py replays).
    env = mgt.make("MiniGrid-Empty-5x5-v0", max_steps=16)
    n, steps = 256, 24
    gen = torch.Generator().manual_seed(3)
    _, states = env.reset(n, gen)
    snapshot = gen.get_state()
    out = fr.fused_rollout(env, states, gen, steps, 2, compute_obs=True)
    gen.set_state(snapshot)
    actions = torch.randint(0, env.num_actions, (steps, n), generator=gen, dtype=torch.int32)
    cache = env.batch_reset_cache(n, 2, gen)
    ref = fr.fused_rollout_core(env, states, cache, actions, True)
    for f in FIELDS:
        assert torch.equal(getattr(out[0], f), getattr(ref[0], f)), f
    assert [float(x) for x in out[1:]] == [float(x) for x in ref[1:]]
    assert float(out[1]) > 0  # the goal is reached on Empty-5x5


# -- counter-reset ext families (ops/fused_ext.py): hooks, extra scalars and
#    in-kernel fresh levels ----------------------------------------------------

COUNTER_CASES = {
    # Random starts, terminations and truncations through the counter reset.
    "empty_random5x5": ("MiniGrid-Empty-Random-5x5-v0", {"max_steps": 9}, 24, 0),
    # Occlusion (see_through_walls=False), lava terminations, regenerated mazes.
    "lavacrossing_s9n2": ("MiniGrid-LavaCrossingS9N2-v0", {"max_steps": 12}, 16, 1),
    # Every hook: the walk, the action remap, collisions; 11 extra scalars.
    "dynamic_obstacles8x8": ("MiniGrid-Dynamic-Obstacles-8x8-v0", {"max_steps": 9}, 16, 4),
    # Random starts drawn by the counter reset, 3 balls.
    "dynamic_obstacles_random6x6": ("MiniGrid-Dynamic-Obstacles-Random-6x6-v0", {"max_steps": 10}, 12, 9),
}


@pytest.mark.parametrize("case", list(COUNTER_CASES))
def test_counter_reset_rollout_matches_jax_kernel(case):
    env_id, kwargs, steps, seed = COUNTER_CASES[case]
    jenv, tenv = mg.make(env_id, **kwargs), mgt.make(env_id, **kwargs)
    _, jstates = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(seed), N))
    rng = np.random.default_rng(seed)
    actions = rng.integers(0, 7, (steps, N), dtype=np.int32)
    seeds = rng.integers(-(2**31), 2**31, (N, 2)).astype(np.int32)
    jfinal, jrew, jdone, jchk, jused = j_fused_rollout_core(
        jenv, jstates, None, jnp.asarray(actions), True, True, jnp.asarray(seeds)  # interpret=True
    )
    before = fr.KERNEL_LAUNCHES
    final, rew, done, chk, used = fr.fused_rollout_core(
        tenv, to_port(jstates), None, torch.from_numpy(actions), True, torch.from_numpy(seeds)
    )
    assert fr.KERNEL_LAUNCHES == before  # CPU tensors: the plain version
    assert_states_equal(final, jfinal, case)  # extra included
    assert int(done) == int(jdone) > N  # every env reset at least once
    assert int(chk) == int(jchk)
    assert int(used) == int(jused) == 0
    np.testing.assert_allclose(float(rew), float(jrew), rtol=1e-5)


def test_fused_rollout_draws_actions_then_seeds():
    # On a counter-reset family fused_rollout is fused_rollout_core on the
    # actions and then the seeds drawn from the generator (what chip_smoke.py
    # replays), with no cache.
    env = mgt.make("MiniGrid-Dynamic-Obstacles-8x8-v0", max_steps=20)
    n, steps = 256, 32
    gen = torch.Generator().manual_seed(3)
    _, states = env.reset(n, gen)
    snapshot = gen.get_state()
    out = fr.fused_rollout(env, states, gen, steps, 2, compute_obs=True)
    gen.set_state(snapshot)
    actions = torch.randint(0, env.num_actions, (steps, n), generator=gen, dtype=torch.int32)
    seeds = torch.randint(-(2**31), 2**31, (n, 2), generator=gen, dtype=torch.int32)
    ref = fr.fused_rollout_core(env, states, None, actions, True, seeds)
    for f in FIELDS:
        assert torch.equal(getattr(out[0], f), getattr(ref[0], f)), f
    for k, v in ref[0].extra.items():
        assert torch.equal(out[0].extra[k], v), k
    assert [float(x) for x in out[1:]] == [float(x) for x in ref[1:]]
    assert int(out[4]) == 0 and float(out[1]) < 0  # collisions cost -1
    with pytest.raises(ValueError, match="reset_seeds"):
        fr.fused_rollout_core(env, states, None, actions, True)


@pytest.mark.parametrize(
    "env_id", ["MiniGrid-Empty-Random-5x5-v0", "MiniGrid-LavaCrossingS9N2-v0", "MiniGrid-Dynamic-Obstacles-8x8-v0"]
)
def test_counter_families_take_the_kernel_on_cuda_and_the_plain_loop_on_cpu(env_id):
    from minigrid_tpu_torch.ops.actor_rollout import supports_fused_actor

    env = mgt.make(env_id)
    assert fr.supports_fused(env) and fr.compiled_ext(env) and fr.counter_reset(env)
    assert fused_eligible(env, "cuda") and not fused_eligible(env, "cpu")
    assert supports_fused_actor(env, "cuda", 1024, 64)  # K2 runs the ext hooks too
    # The plain path: the shared pool for an expensive_reset family, per-step
    # regeneration (nothing to run out) for Empty-Random.
    capacity = rollout_capacity(env, 64, "cpu", num_envs=64)
    assert capacity == (pool_size(env, 64, 64) if env.expensive_reset else 0)
    gen = torch.Generator().manual_seed(1)
    _, states = VectorEnv(env, 64, "cpu").reset(gen)
    before = fr.KERNEL_LAUNCHES
    final, total_r, total_done, max_used = rollout_random(env, states, gen, 64)
    assert fr.KERNEL_LAUNCHES == before
    assert int(total_done) > 0 and torch.isfinite(total_r)
    assert int(max_used) == (int(total_done) if env.expensive_reset else 0) and int(max_used) <= capacity
    assert (final.extra is None) == (env.fused_ext.n_scalars == 0)
    assert int(final.step_count.max()) < env.max_steps


@pytest.mark.parametrize("env_id", ["MiniGrid-DoorKey-5x5-v0", "BabyAI-GoToLocal-v0", "MiniGrid-Empty-Random-5x5-v0"])
def test_the_kernel_takes_state_and_cache_where_they_lie(env_id):
    # The rollout kernel's buffers: the cache's grid, contents and mission,
    # the ext's cache scalars and planes as batch_reset_cache and the ext's
    # pack give them, no permute; the state's grid cloned [N, W*H].
    env = mgt.make(env_id)
    gen = torch.Generator().manual_seed(0)
    n, wh = 32, env.width * env.height
    _, states = env.reset(n, gen, "cpu")
    counter = fr.counter_reset(env)
    cache = None if counter else env.batch_reset_cache(n, 3, gen, "cpu")
    seeds = torch.zeros((n, 2), dtype=torch.int32) if counter else None
    b = fr.kernel_buffers(env, states, cache, seeds)
    assert b.grid.shape == (n, wh) and b.grid.is_contiguous() and b.grid.data_ptr() != states.grid.data_ptr()
    assert torch.equal(b.grid, states.grid.reshape(n, wh)) and b.sc.shape == (8, n)
    assert b.ext.env_major
    if counter:
        assert b.cgrid is None and b.csc == (None,) * 8 and b.ext.seeds.data_ptr() == seeds.data_ptr()
        return
    for got, leaf in ((b.cgrid, cache.grid), (b.ccont, cache.contains), (b.cmis, cache.mission)):
        assert got.data_ptr() == leaf.data_ptr() and got.is_contiguous()
    fields = [getattr(cache, f) for f in ("agent_x", "agent_y", "agent_dir", "carrying", "step_count", "max_steps")]
    for got, leaf in zip(b.csc, fields + [cache.terminated, cache.truncated]):
        assert got.data_ptr() == leaf.data_ptr() and got.shape == (n, 3)
    if env.fused_ext is not None:
        k, p = env.fused_ext.n_scalars, env.fused_ext.n_planes
        assert b.ext.scal.shape == (n, k) and b.ext.cscal.shape == (n, 3, k)
        assert b.ext.planes.shape == (n, p, wh) and b.ext.cplanes.shape == (n, 3, p, wh)
        leaves = tree_leaves(fr.with_extra(env, states.replace(extra=None), b.ext).extra)
        assert [k for k, _ in leaves] == [k for k, _ in tree_leaves(states.extra)]
        for (k, got), (_, want) in zip(leaves, tree_leaves(states.extra)):
            assert torch.equal(got, want), k
