"""Helpers shared by the ``test_torch_*`` files, which hold the PyTorch port
(``minigrid_tpu_torch``) against the JAX package on the same inputs.  States
cross between the two as numpy arrays (``minigrid_tpu_torch.utils.bridge``)."""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minigrid_tpu as mg
from minigrid_tpu.core.env import MiniGridEnv as JEnv
from minigrid_tpu.core.state import EnvState as JState
from minigrid_tpu.rl import model as jmodel
from minigrid_tpu_torch.core.state import FIELDS, tree_leaves
from minigrid_tpu_torch.rl import model as tmodel
from minigrid_tpu_torch.utils.bridge import params_from_flax, state_from_numpy, state_to_numpy
from minigrid_tpu_torch.utils.synthetic import random_states

HIDDEN = 64  # the narrow width of the network tests

# Under pytest-xdist the workers share the machine's cores: torch's CPU ops
# take each worker's share of them (at least one thread), as
# ``one_torch_thread`` gives the learners' tests.  At full width every
# worker's pool of threads contends with the others' (one profiler case,
# ``tests/test_torch_profiler.py``'s IMPALA step chain, took 186 s among six
# workers on 8 cores and 1.6 s alone on one thread).  Every worker imports
# this module while it collects the suite, so the share holds for all of
# its tests.
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))


def jax_to_numpy(state) -> dict:
    """The port's fields of a JAX ``EnvState`` (or cache), as numpy, with
    its ``extra`` mapping where it has one."""
    leaves = jax.tree.map(np.asarray, state)
    out = {f: getattr(leaves, f) for f in FIELDS}
    if leaves.extra is not None:
        out["extra"] = dict(leaves.extra)
    return out


def to_port(state, device="cpu", extra_types=None):
    return state_from_numpy(jax_to_numpy(state), device, extra_types)


def assert_states_equal(port_state, jax_state, what: str = "") -> None:
    """Every field and ``extra`` leaf of the port's state equals the JAX
    state's, bit for bit."""
    got = state_to_numpy(port_state)
    want = jax_to_numpy(jax_state)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"{what}: {f}")
    assert ("extra" in got) == ("extra" in want), f"{what}: extra on one side only"
    for k, v in want.get("extra", {}).items():
        want_leaves, got_leaves = _fields(v), _fields(got["extra"][k])
        assert want_leaves.keys() == got_leaves.keys(), f"{what}: extra {k} structure"
        for name, want_leaf in want_leaves.items():
            got_leaf = got_leaves[name]
            assert got_leaf.dtype == want_leaf.dtype, f"{what}: extra {k}{name} dtype"
            np.testing.assert_array_equal(got_leaf, want_leaf, err_msg=f"{what}: extra {k}{name}")


def assert_trees_equal(got, want) -> None:
    """Two trees of the port's tensors (``core/state.tree_leaves``) equal
    leaf for leaf: paths, dtypes, devices and values."""
    a, b = tree_leaves(got), tree_leaves(want)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and x.device == y.device, path
        assert torch.equal(x, y), path


def _fields(value) -> dict:
    """The leaves of an ``extra`` value by name: an array as ``""``, an
    instruction state (the JAX dataclass or the bridge's mapping) by
    ``".field"``."""
    if dataclasses.is_dataclass(value):
        value = {f.name: getattr(value, f.name) for f in dataclasses.fields(value)}
    if isinstance(value, dict):
        return {f".{k}": np.asarray(x) for k, x in value.items()}
    return {"": np.asarray(value)}


def jax_state(arrays):
    """A JAX ``EnvState`` of numpy field arrays (zero rng keys), with the
    ``"extra"`` mapping where ``arrays`` has one."""
    keys = jnp.zeros(arrays["step_count"].shape + (2,), jnp.uint32)
    extra = arrays.get("extra")
    fields = {k: jnp.asarray(v) for k, v in arrays.items() if k != "extra"}
    if extra is not None:
        fields["extra"] = {k: jnp.asarray(v) for k, v in extra.items()}
    return JState(**fields, rng=keys)


def to_jax(port_state):
    """The JAX ``EnvState`` (or cache) of a port state, ``extra`` included."""
    return jax_state(state_to_numpy(port_state))


def observations(n_each=128, seed=0):
    """Packed views and directions of Empty-5x5 resets and of random
    object-rich 9x7 states (occlusion, doors, carried objects), from JAX."""
    env = mg.make("MiniGrid-Empty-5x5-v0")
    _, states = jax.jit(jax.vmap(env.reset))(jax.random.split(jax.random.PRNGKey(seed), n_each))
    rich_env = JEnv(9, 7, max_steps=100)
    rich = jax_state(random_states(np.random.default_rng(seed), (n_each,), 9, 7))
    packed = [
        jax.vmap(lambda s, e=e: e.observation_packed(s).reshape(-1))(st)
        for e, st in ((env, states), (rich_env, rich))
    ]
    return (
        np.concatenate([np.asarray(p) for p in packed]),
        np.concatenate([np.asarray(states.agent_dir), np.asarray(rich.agent_dir)]),
    )


def jax_learner_init(init_fn, key, num_envs: int):
    """A JAX learner's ``init_fn(key, num_envs)`` under one ``jax.jit``: the
    same state from one compile, where op-by-op dispatch of its vmapped
    reset, observation and flax init takes 10-14 s on the CPU."""
    return jax.jit(init_fn, static_argnums=1)(key, num_envs)


def with_bias_noise(params, seed, scale=0.1):
    """``params`` (a flax tree of numpy arrays) with N(0, ``scale``) noise
    added to every bias, which flax initialises to 0, so that the bias
    arithmetic and its rounding order are compared too."""
    rng = np.random.default_rng(seed)

    def noisy(path, x):
        if path[-1].key != "bias":
            return x
        return (x + rng.normal(0, scale, x.shape)).astype(x.dtype)

    return jax.tree_util.tree_map_with_path(noisy, params)


def flax_params(packed, direction, hidden=HIDDEN, seed=1):
    """A flax ``ActorCritic`` and its parameters: flax's init, with nonzero
    biases (``with_bias_noise``)."""
    model = jmodel.ActorCritic(hidden=hidden, num_actions=7)
    params = model.init(jax.random.PRNGKey(seed), packed[:1], direction[:1], packed=True)
    return model, with_bias_noise(jax.tree.map(np.array, params), seed)


def port_model(params, hidden=HIDDEN):
    model = tmodel.ActorCritic(hidden=hidden, num_actions=7, device="cpu")
    model.load_state_dict(params_from_flax(params))
    return model


@pytest.fixture
def one_torch_thread():
    """torch's CPU ops on one thread for the test, restored after it: a
    learner's small ops gain nothing from more, and the suite's workers
    share the machine's cores, where each worker's own pool of threads
    would contend with the others'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
