"""Helpers of the ``test_torch_babyai_*`` files, which hold the port's BabyAI
levels (``minigrid_tpu_torch/envs/babyai``) against the JAX package's.

* ``check_ids``: every id of a module resets and steps at N=4 on the CPU,
  its mission text equal to JAX's ``babyai_mission_text`` on the same
  encoded mission.
* ``compare_generation``: levels of one class from both packages (the
  port's reset cache, JAX's valid attempts or its ``_generate``) reduced to
  their features (the instruction's shape, every descriptor's type, color,
  location and plurality, the doors with their colors and locks, the
  objects by type and color, the agent's room and direction, the step
  limit, what the agent carries and what the boxes hold), compared value by
  value.  The rule: for a value seen with frequency pa among na port levels
  and pb among nb JAX levels, |pa - pb| <= 5 sigma, sigma =
  sqrt(max(p (1 - p), 1 / (na + nb)) (1 / na + 1 / nb)) with p the pooled
  frequency (the floor keeps a value seen once on one side from failing).
* ``check_steps_exact``: JAX's levels carried across by ``utils/bridge.py``
  and stepped by JAX's ``step_cached`` and the port's plain one with the
  same actions and the same R=2 reset cache: every state bit-identical,
  the ``InstrState`` included, rewards to rtol 1e-6 (XLA's FMA).
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

import minigrid_tpu as mg
import minigrid_tpu_torch as mgt
from minigrid_tpu.core.state import EnvState as JState
from minigrid_tpu.envs.babyai.core.instr import InstrState as JInstrState
from minigrid_tpu.envs.babyai.core.text import babyai_mission_text as j_mission_text
from minigrid_tpu_torch.core.constants import OBJ_BALL, OBJ_BOX, OBJ_DOOR, OBJ_KEY
from minigrid_tpu_torch.envs.babyai.core.instr import InstrState
from minigrid_tpu_torch.utils.bridge import state_to_numpy
from torch_port_util import assert_states_equal, jax_to_numpy
from torch_port_util import to_port as _to_port

N_GEN = 2048
SIGMAS = 5
EXACT_ENVS, EXACT_STEPS, EXACT_R = 64, 32, 2
EXTRA_TYPES = {"instr": InstrState}


@contextlib.contextmanager
def one_torch_thread():
    """torch's CPU ops on one thread inside the block: the suite's workers
    share the machine's cores, and each worker's own pool of threads would
    contend with the others' (tests/torch_port_util.one_torch_thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def to_port(state):
    return _to_port(state, extra_types=EXTRA_TYPES)


def to_jax(port_state) -> JState:
    """The JAX ``EnvState`` of a port BabyAI state or cache (zero rng keys)."""
    arrays = state_to_numpy(port_state)
    instr = arrays.pop("extra")["instr"]
    keys = jnp.zeros(arrays["step_count"].shape + (2,), jnp.uint32)
    fields = {k: jnp.asarray(v) for k, v in arrays.items()}
    return JState(**fields, rng=keys, extra={"instr": JInstrState(**{k: jnp.asarray(v) for k, v in instr.items()})})


def module_ids(module: str) -> list[str]:
    """The registered BabyAI ids whose class lives in ``envs/babyai/<module>.py``."""
    from minigrid_tpu_torch.registry import _REGISTRY

    return sorted(i for i, (cls, _) in _REGISTRY.items() if cls.__module__ == f"minigrid_tpu_torch.envs.babyai.{module}")


@one_torch_thread()
def check_ids(env_id: str) -> None:
    env = mgt.make(env_id)
    gen = torch.Generator().manual_seed(3)
    obs, state = env.reset(4, gen)
    assert obs["image"].shape == (4, 7, 7, 3) and state.mission.shape == (4, 44)
    assert state.grid.shape == (4, env.width, env.height) and bool((state.max_steps > 0).all())
    assert bool((state.extra["instr"].leaf_kind[:, 0] >= 0).all())
    for _ in range(8):
        action = torch.randint(0, 7, (4,), generator=gen, dtype=torch.int32)
        obs, state, reward, term, trunc = env.step(state, action, gen)
        assert reward.shape == (4,) and bool(torch.isfinite(reward).all())
    for i in range(4):
        assert env.mission_text(state.mission[i]) == j_mission_text(state.mission[i].numpy())


# -- generation by distribution ---------------------------------------------------------


def _features(st: dict, room_size: int, num_cols: int) -> dict[str, np.ndarray]:
    """Per-level features of a batch of levels (numpy fields, ``extra``'s
    instruction as a field mapping)."""
    instr = st["extra"]["instr"]
    if not isinstance(instr, dict):
        instr = {k: np.asarray(getattr(instr, k)) for k in ("top_kind", "a_is_and", "b_is_and", "leaf_kind", "leaf_strict", "d_type", "d_color", "d_loc", "d_plural", "carried")}
    grid = np.asarray(st["grid"])
    n = grid.shape[0]
    types, colors, states = grid & 0xFF, (grid >> 8) & 0xFF, (grid >> 16) & 0xFF
    out = {
        "top": instr["top_kind"],
        "a_is_and": instr["a_is_and"],
        "b_is_and": instr["b_is_and"],
        "carried": (np.asarray(instr["carried"]).reshape(n, -1) * (1 << np.arange(8))).sum(axis=1),
        "agent room": (st["agent_x"] // (room_size - 1)) + num_cols * (st["agent_y"] // (room_size - 1)),
        "agent dir": st["agent_dir"],
        "max_steps": st["max_steps"],
        "carrying": st["carrying"],
        "doors": (types == OBJ_DOOR).sum(axis=(1, 2)),
        "locked doors": ((types == OBJ_DOOR) & (states == 2)).sum(axis=(1, 2)),
        "box contents": np.where(types == OBJ_BOX, np.asarray(st["contains"]), 0).reshape(n, -1).max(axis=1),
    }
    for leaf in range(4):
        out[f"leaf {leaf} kind"] = instr["leaf_kind"][:, leaf]
        out[f"leaf {leaf} strict"] = instr["leaf_strict"][:, leaf]
        for d in range(2):
            for field in ("d_type", "d_color", "d_loc", "d_plural"):
                out[f"{field} {leaf}.{d}"] = instr[field][:, leaf, d]
    for c in range(6):
        out[f"doors of color {c}"] = ((types == OBJ_DOOR) & (colors == c)).sum(axis=(1, 2))
        out[f"objects of color {c}"] = ((types >= OBJ_KEY) & (types <= OBJ_BOX) & (colors == c)).sum(axis=(1, 2))
    for name, kind in (("keys", OBJ_KEY), ("balls", OBJ_BALL), ("boxes", OBJ_BOX)):
        out[name] = (types == kind).sum(axis=(1, 2))
    return {k: np.asarray(v).astype(np.int64).reshape(n) for k, v in out.items()}


def assert_same_distribution(got: dict, want: dict, room_size: int, num_cols: int, what: str) -> None:
    """Every feature's frequencies within ``SIGMAS`` binomial sigmas (the
    rule of the module docstring)."""
    fa, fb = _features(got, room_size, num_cols), _features(want, room_size, num_cols)
    for name, a in fa.items():
        b = fb[name]
        na, nb = a.size, b.size
        for value in np.union1d(a, b):
            pa, pb = (a == value).mean(), (b == value).mean()
            p = ((a == value).sum() + (b == value).sum()) / (na + nb)
            sigma = np.sqrt(max(p * (1 - p), 1 / (na + nb)) * (1 / na + 1 / nb))
            assert abs(pa - pb) <= SIGMAS * sigma, f"{what}: {name} = {value}: port {pa:.4f}, JAX {pb:.4f} ({sigma:.4f} sigma)"


def jax_levels(env_id: str, n: int, seed: int = 12):
    """JAX's ``_generate`` (its reset) of ``n`` levels of ``env_id``."""
    jenv = mg.make(env_id)
    _, states = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(seed), n))
    return states


def jax_valid_attempts(env_id: str, n: int, seed: int = 12):
    """The levels of JAX's valid attempts among ``n``, finished as its
    ``_generate`` finishes the first valid one, and the attempts' validity
    rate.  ``_generate`` keeps the first valid attempt of independent ones,
    so its levels are distributed as these are; its rejection loop about
    doubles the compile, and under ``vmap`` every lane waits for the
    slowest."""
    jenv = mg.make(env_id)

    def attempt(key):
        k_attempt, k_fin = jax.random.split(key)
        s, instr, valid = jenv.gen_attempt(k_attempt)
        valid &= jenv._validate(s, instr)
        return jenv._finish_level(s, instr, k_fin), valid

    states, valid = jax.jit(jax.vmap(attempt))(jax.random.split(jax.random.PRNGKey(seed), n))
    keep = np.flatnonzero(np.asarray(valid))
    return jax.tree.map(lambda a: a[keep], states), float(np.asarray(valid).mean())


@one_torch_thread()
def compare_generation(env_id: str, want_state, seed: int = 11) -> None:
    """``N_GEN`` levels of the port's reset cache (the pooled valid
    attempts, finished) against JAX's levels ``want_state``, feature by
    feature; and the class's flags."""
    env = mgt.make(env_id)
    got = env.batch_reset_cache(N_GEN, 1, torch.Generator().manual_seed(seed), "cpu").map(lambda a: a[:, 0])
    want = jax_to_numpy(want_state)
    b = env.builder
    assert_same_distribution(state_to_numpy(got), want, b.room_size, b.num_cols, env_id)
    jenv = mg.make(env_id)
    for attr in ("width", "height", "max_steps", "fixed_max_steps", "unblocking", "see_through_walls", "expensive_reset"):
        assert getattr(env, attr) == getattr(jenv, attr), attr


def jax_generation(classes: dict[str, str], generate: tuple[str, ...] = ()) -> dict:
    """JAX's levels of each class's id: its valid attempts among
    ``N_GEN``, or its ``_generate`` for the classes in ``generate`` (those
    whose ``_generate`` adds to the finished attempt)."""
    return {
        cls: jax_levels(env_id, N_GEN) if cls in generate else jax_valid_attempts(env_id, N_GEN)[0]
        for cls, env_id in classes.items()
    }


# -- exactness where no draw decides ------------------------------------------------------


@one_torch_thread()
def check_steps_exact(env_id: str, levels) -> None:
    """JAX's ``levels`` (at least EXACT_ENVS * (1 + EXACT_R)): the first
    EXACT_ENVS as the start states, the next as an R=2 cache, stepped
    EXACT_STEPS times with the same random actions by JAX's
    ``step_cached`` and the port's."""
    n, r = EXACT_ENVS, EXACT_R
    jstates = jax.tree.map(lambda a: a[:n], levels)
    # Episode ages near the step limit, so that truncations reset from
    # the cache within the run as well as the level's own ends.
    ages = np.random.default_rng(4).integers(1, 2 * EXACT_STEPS, n).astype(np.int32)
    jstates = jstates.replace(step_count=jnp.maximum(jstates.max_steps - jnp.asarray(ages), 0))
    jcache = jax.tree.map(lambda a: a[n : n * (1 + r)].reshape((n, r) + a.shape[1:]), levels)
    jenv, env = mg.make(env_id), mgt.make(env_id)
    actions = np.random.default_rng(5).integers(0, 7, (EXACT_STEPS, n), dtype=np.int32)
    states, cache = to_port(jstates), to_port(jcache)
    jused, used = jnp.zeros(n, jnp.int32), torch.zeros(n, dtype=torch.int32)
    jstep = jax.jit(jax.vmap(jenv.step_cached))
    for t in range(EXACT_STEPS):
        jobs, jstates, jr, jterm, jtrunc, jused = jstep(jstates, jnp.asarray(actions[t]), jcache, jused)
        obs, states, rew, term, trunc, used = env.step_cached(states, torch.from_numpy(actions[t]), cache, used)
        np.testing.assert_array_equal(obs["image"].numpy(), np.asarray(jobs["image"]), err_msg=f"{env_id} obs {t}")
        np.testing.assert_array_equal(term.numpy(), np.asarray(jterm), err_msg=f"{env_id} terminated {t}")
        np.testing.assert_array_equal(trunc.numpy(), np.asarray(jtrunc), err_msg=f"{env_id} truncated {t}")
        np.testing.assert_array_equal(used.numpy(), np.asarray(jused), err_msg=f"{env_id} used {t}")
        np.testing.assert_allclose(rew.numpy(), np.asarray(jr), rtol=1e-6, atol=0, err_msg=f"{env_id} reward {t}")
        assert_states_equal(states, jstates, f"{env_id} step {t}")
    assert int(used.max()) > 0, f"{env_id}: no episode ended in {EXACT_STEPS} steps"
