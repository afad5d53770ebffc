"""Helpers shared by the ``test_torch_parity*`` files: the port's seed-parity
mode (``minigrid_tpu_torch.compat``) against the JAX package's on the same
seeds and actions, on the CPU.  JAX's parity states are single envs; the
port's are batches of one, so JAX's leaves gain a leading axis of 1 before
the bridge carries them across."""

from __future__ import annotations

import jax
import numpy as np

import minigrid_tpu as mg
import minigrid_tpu_torch as mgt
from minigrid_tpu.compat import parity as jparity
from minigrid_tpu.utils.debug import state_hash as jax_state_hash
from minigrid_tpu_torch.compat import parity as tparity
from minigrid_tpu_torch.utils.debug import state_hash
from torch_port_util import assert_states_equal

REWARD_RTOL = 1e-6


def batched(jax_state):
    """A single-env JAX state as a batch of one: every leaf (``extra``'s
    instruction state included) as a numpy array with a leading axis of 1."""
    return jax.tree.map(lambda a: np.asarray(a)[None], jax_state)


def assert_parity_states_equal(port_state, jax_state, key_seed: int, what: str) -> None:
    """Every field and ``extra`` leaf of the port's parity state equals the
    JAX package's, bit for bit, except Dynamic-Obstacles' walk stream: both
    packages leave it to their own generators (JAX's template key, the
    port's parity seed), and parity stepping never reads it."""
    want = batched(jax_state)
    extra = port_state.extra
    if extra is not None and "walk_seed" in extra:
        np.testing.assert_array_equal(
            extra["walk_seed"].numpy(), tparity._walk_seed(key_seed, "cpu").numpy(), err_msg=f"{what}: walk_seed"
        )
        assert want.extra["walk_seed"].shape == extra["walk_seed"].shape
        want = want.replace(extra=dict(want.extra, walk_seed=extra["walk_seed"].numpy()))
    assert_states_equal(port_state, want, what)


def assert_observations_equal(port_obs, jax_obs, port_env, jax_env, what: str) -> None:
    """The port's observation of a batch of one equals JAX's of one env:
    image, direction, mission vector and mission text."""
    np.testing.assert_array_equal(port_obs["image"][0].numpy(), np.asarray(jax_obs["image"]), err_msg=f"{what}: image")
    assert int(port_obs["direction"][0]) == int(jax_obs["direction"]), f"{what}: direction"
    np.testing.assert_array_equal(
        port_obs["mission"][0].numpy(), np.asarray(jax_obs["mission"]), err_msg=f"{what}: mission"
    )
    assert port_env.mission_text(port_obs["mission"][0]) == jax_env.mission_text(jax_obs["mission"]), what


def assert_reset_parity(env_id: str, seeds) -> None:
    """``parity_reset(env_id, seed)`` of both packages for each seed, each
    package on one env instance (which keeps its template): the whole
    state, the mission text, the first observation and the state hash."""
    jenv, tenv = mg.make(env_id), mgt.make(env_id)
    for seed in seeds:
        _, jstate = jparity.parity_reset(jenv, seed)
        _, tstate = tparity.parity_reset(tenv, seed, device="cpu")
        what = f"{env_id} seed={seed}"
        assert tstate.grid.shape == (1, jenv.width, jenv.height), what
        assert_parity_states_equal(tstate, jstate, seed, what)
        assert tenv.mission_text(tstate.mission[0]) == jenv.mission_text(jstate.mission), what
        assert_observations_equal(tenv.observation(tstate), jenv.observation(jstate), tenv, jenv, what)
        assert state_hash(tstate) == jax_state_hash(jstate), what


def assert_trajectory_parity(env_id: str, seed: int = 0, steps: int = 40) -> int:
    """``steps`` numpy-seeded actions through JAX's ``ParityRollout`` and the
    port's, an unseeded reset of both where an episode ends: each step's
    observation, direction, terminated and truncated exact, its reward to
    rtol 1e-6, its state equal.  Returns the episodes ended."""
    jroll = jparity.ParityRollout(env_id, seed)
    troll = tparity.ParityRollout(env_id, seed, device="cpu")
    assert_parity_states_equal(troll.state, jroll.state, seed, f"{env_id} reset")
    rng = np.random.default_rng(seed + 1000)
    ended = 0
    for t in range(steps):
        action = int(rng.integers(0, 7))
        what = f"{env_id} seed={seed} t={t} action={action}"
        jobs, jr, jterm, jtrunc = jroll.step(action)
        tobs, tr, tterm, ttrunc = troll.step(action)
        assert_observations_equal(tobs, jobs, troll.env, jroll.env, what)
        assert (tterm, ttrunc) == (jterm, jtrunc), what
        assert abs(tr - jr) <= REWARD_RTOL * abs(jr), f"{what}: reward {tr} != {jr}"
        assert_parity_states_equal(troll.state, jroll.state, seed, what)
        if jterm or jtrunc:
            ended += 1
            jobs, tobs = jroll.reset(), troll.reset()
            assert_observations_equal(tobs, jobs, troll.env, jroll.env, f"{what} reset")
            assert_parity_states_equal(troll.state, jroll.state, seed, f"{what} reset")
    return ended
