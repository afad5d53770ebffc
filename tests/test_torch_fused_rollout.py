"""The PyTorch port's whole-rollout op against the JAX package's fused kernel.

On the CPU the port's ``fused_rollout_core`` runs its plain version; the JAX
side runs the Pallas kernel in interpret mode, as tests/test_fused_rollout.py
does.  Both get the same states, reset cache and actions.  Integers must be
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
from minigrid_tpu_torch.core.state import FIELDS
from minigrid_tpu_torch.ops import fused_rollout as fr
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
    "fourrooms": lambda: _jax_case("MiniGrid-FourRooms-v0", {"max_steps": 10}, 2, 5),
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
    steps = 12 if case == "fourrooms" else 24
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
    _, states = VectorEnv(env, 64).reset(gen)
    final, total_r, total_done, max_used = rollout_random(env, states, gen, 300)
    assert final.step_count.shape == (64,) and int(final.step_count.max()) < env.max_steps
    assert int(total_done) >= 64 and int(max_used) == 0 and torch.isfinite(total_r)
    assert fr.KERNEL_LAUNCHES == before


def test_fused_rollout_draws_actions_then_cache():
    # fused_rollout is fused_rollout_core on the actions and cache drawn from
    # the generator, in that order (what chip_smoke.py replays).
    env = mgt.make("MiniGrid-Empty-5x5-v0", max_steps=16)
    n, steps = 1024, 64
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
