"""Writing a family of your own against the port, held to the JAX package.

* ``register_mission``, ``num_templates``, ``mission_to_text``,
  ``MissionSpace`` and ``registry.registry_entry`` twin the JAX package's.
* An example family defined here, outside both packages: the tutorial's
  8x8 room (walls, goal at (6, 6)) with a random start cell and direction,
  its own mission, and one extra scalar, ``turns``: the consecutive left or
  right turns, reset to 0 by any other action; at 4 the episode ends with
  reward 0.  It is written twice, in JAX (``_jax_turns_env``: a
  ``_post_step`` override and an ``extra`` leaf) and in the port
  (``TurnsEnv``, whose ``TurnsFusedExt`` names its CUDA twin, the header
  ``TURNS_HEADER``, built into the rollout kernels at first launch).  Its
  ``step_env`` equals JAX's bit for bit, its levels are held by
  distribution, and the kernels' plain versions run it.
* The short-chunk reset budget: the fused path's default R for a chunk of
  up to 256 steps is the 256-step R.

JAX is imported only inside the tests that compare with it, so that
``tests/test_torch_cuda.py``, which runs where JAX is not installed, can
import the port's family from here.  Every template a test registers goes
into both packages' tables in the same order, and the tables and
registries are restored after this module (``tests/test_torch_bridge.py``
holds the two tables equal).
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import minigrid_tpu_torch as mgt
from minigrid_tpu_torch import registry as treg
from minigrid_tpu_torch.core import grid as g
from minigrid_tpu_torch.core import mission as tm
from minigrid_tpu_torch.core import sampling as s_
from minigrid_tpu_torch.core.actions import Actions
from minigrid_tpu_torch.core.constants import EMPTY_CELL, GOAL_CELL, WALL_CELL
from minigrid_tpu_torch.core.env import MiniGridEnv
from minigrid_tpu_torch.core.state import new_state
from minigrid_tpu_torch.ops import _build
from minigrid_tpu_torch.ops import actor_rollout as ar
from minigrid_tpu_torch.ops import fused_ext as fx
from minigrid_tpu_torch.ops import fused_rollout as fr
from minigrid_tpu_torch.parallel import reset_budget as trb
from minigrid_tpu_torch.parallel.vector import fused_eligible, rollout_capacity
from minigrid_tpu_torch.rl.model import ActorCritic

TURNS_MISSION = "you must reach the goal square"
TUTORIAL_MISSION = "grand mission"
MAX_TURNS = 4
TURNS_ID = "MiniGrid-Turns-8x8-v0"

# The family's CUDA twin: a struct deriving from NoExt, as the headers of
# minigrid_tpu_torch/ops/csrc/ext/ are, with one extra scalar.
TURNS_HEADER = r"""// Turns: four left or right turns in a row end the episode with reward 0.
#pragma once

#include "fused_ext.cuh"

namespace minigrid {

struct TurnsExt : NoExt {
  // No objects, a static mission, occluding walls.
  static constexpr int SWITCHES[3] = {1, 1, 0};
  static constexpr int MAX_K = 1;

  struct Extra {
    int turns;
  };

  __device__ static Extra load(const int* scal, int n, size_t, const ExtParams&) { return Extra{scal[n]}; }

  __device__ static void store(int* scal, int n, size_t, const ExtParams&, const Extra& x) { scal[n] = x.turns; }

  __device__ static bool post_step(const ExtParams&, const StepCtx& ctx, float& reward, Extra& x) {
    x.turns = (ctx.action == ACT_LEFT || ctx.action == ACT_RIGHT) ? x.turns + 1 : 0;
    const bool dizzy = x.turns >= 4;
    if (dizzy) reward = 0.0f;
    return dizzy;
  }
};

}  // namespace minigrid
"""


class TurnsFusedExt(fx.CachedExt):
    """The port's twin of the example family's hooks: ``post_step`` is the
    plain version of ``TurnsExt::post_step``; ``turns`` is blended from
    the reset cache at every reset."""

    n_scalars = 1
    kernel_id = fx.EXT_USER
    kernel_struct = "TurnsExt"
    kernel_switches = (True, True, False)

    def __init__(self, header=None, max_turns: int = MAX_TURNS):
        self.kernel_source = None if header is None else str(header)
        self.max_turns = max_turns  # the header's 4 (the tests edit both)

    def pack_extra(self, env, extra):
        return extra["turns"][..., None].to(torch.int32)

    def unpack_extra(self, env, scal, planes=None):
        return {"turns": scal[..., 0]}

    def post_step(self, env, prev, state, action, reward, scal):
        turning = (action == Actions.left) | (action == Actions.right)
        turns = torch.where(turning, scal[:, 0] + 1, 0).to(torch.int32)
        dizzy = turns >= self.max_turns
        return dizzy, torch.where(dizzy, 0.0, reward), turns[:, None]


class TurnsEnv(MiniGridEnv):
    """The example family in the port.  ``header`` is the path of
    ``TURNS_HEADER`` written to a file; without it the kernels have no twin
    of the family."""

    fused_no_objects = True
    fused_static_mission = True

    def __init__(self, size: int = 8, max_steps: int = 256, header=None, **kwargs):
        super().__init__(width=size, height=size, max_steps=max_steps, **kwargs)
        self.fused_ext = TurnsFusedExt(header)
        self.mission_id = tm.register_mission(TURNS_MISSION)

    def _generate(self, num_envs, generator, device):
        w, h = self.width, self.height
        grid = g.wall_rect(g.empty_grid(num_envs, w, h, device), 0, 0, w, h)
        grid = g.set_cell(grid, w - 2, h - 2, GOAL_CELL)
        return new_state(
            grid,
            s_.place_obj_pos(generator, grid),
            s_.rand_dir(generator, num_envs, device),
            self.max_steps,
            mission=tm.mission_vec(self.mission_id),
            extra={"turns": torch.zeros(num_envs, dtype=torch.int32, device=device)},
        )

    def _post_step(self, prev, state, action, reward):
        return self.fused_ext.apply_post_step(self, prev, state, action, reward)


def write_header(directory: Path, text: str = TURNS_HEADER) -> Path:
    path = Path(directory) / "turns.cuh"
    path.write_text(text)
    return path


def _jax_turns_env():
    """The example family in JAX: a ``MiniGridEnv`` subclass with a
    ``_post_step`` override and an ``extra`` leaf."""
    import jax
    import jax.numpy as jnp

    from minigrid_tpu.core import grid as jg
    from minigrid_tpu.core.constants import GOAL_CELL as J_GOAL_CELL
    from minigrid_tpu.core.env import MiniGridEnv as JEnv
    from minigrid_tpu.core.mission import mission_vec, register_mission
    from minigrid_tpu.core.sampling import place_obj_pos, rand_dir
    from minigrid_tpu.core.state import new_state as j_new_state

    class JaxTurnsEnv(JEnv):
        fused_no_objects = True
        fused_static_mission = True

        def __init__(self, size: int = 8, max_steps: int = 256, **kwargs):
            super().__init__(width=size, height=size, max_steps=max_steps, **kwargs)
            self.mission_id = register_mission(TURNS_MISSION)

        def _generate(self, key):
            k_pos, k_dir, k_rng = jax.random.split(key, 3)
            w, h = self.width, self.height
            grid = jg.wall_rect(jg.empty_grid(w, h), 0, 0, w, h)
            grid = jg.set_cell(grid, w - 2, h - 2, J_GOAL_CELL)
            return j_new_state(
                grid=grid,
                agent_pos=place_obj_pos(k_pos, grid),
                agent_dir=rand_dir(k_dir),
                rng=k_rng,
                max_steps=self.max_steps,
                mission=mission_vec(self.mission_id),
                extra={"turns": jnp.asarray(0, jnp.int32)},
            )

        def _post_step(self, prev_state, state, action, reward):
            turning = (action == 0) | (action == 1)
            turns = jnp.where(turning, state.extra["turns"] + 1, 0).astype(jnp.int32)
            dizzy = turns >= MAX_TURNS
            state = state.replace(terminated=state.terminated | dizzy, extra={"turns": turns})
            return state, jnp.where(dizzy, 0.0, reward)

    return JaxTurnsEnv()


@pytest.fixture(scope="module", autouse=True)
def twin_tables():
    """Register the example family's template in both packages, and restore
    both tables and registries after the module."""
    from minigrid_tpu import registry as jreg
    from minigrid_tpu.core import mission as jm

    saved = [(tm.TEMPLATES, tm._TEMPLATE_IDS), (jm._TEMPLATES, jm._TEMPLATE_IDS)]
    lengths = [len(t) for t, _ in saved]
    ids = [set(treg._REGISTRY), set(jreg._REGISTRY)]
    assert tm.register_mission(TURNS_MISSION) == jm.register_mission(TURNS_MISSION)
    yield
    for (table, index), n in zip(saved, lengths):
        for key in table[n:]:
            del index[key]
        del table[n:]
    for registry, before in zip((treg._REGISTRY, jreg._REGISTRY), ids):
        for env_id in set(registry) - before:
            del registry[env_id]


# -- Missions and registry ---------------------------------------------------


@pytest.mark.parametrize(
    "template, params, values",
    [
        ("pick up the {0} {1} and then find the goal", ("color", "type"), (2, 6)),
        ("go to the goal at {0}", ("int",), (7,)),
        ("get to the green goal square", (), ()),  # built in: its first id
    ],
)
def test_register_mission_twins_jax(template, params, values):
    from minigrid_tpu.core import mission as jm

    tid = tm.register_mission(template, params)
    assert tid == jm.register_mission(template, params)
    assert tm.register_mission(template, params) == tid  # a repeat keeps its id
    assert tm.num_templates() == jm.num_templates() == len(tm.TEMPLATES)
    assert tm.template_id(template, params) == tid
    vec = tm.mission_vec(tid, *values)
    assert tm.mission_to_text(vec) == jm.mission_to_text(np.asarray(vec))
    if not params:
        assert tid == 2


def test_token_tables_read_the_live_table():
    from minigrid_tpu.core import mission as jm

    template = "go to the {0} key then the {1} door"
    tid = tm.register_mission(template, ("color", "color"))
    assert tid == jm.register_mission(template, ("color", "color"))
    tables = tm.build_token_tables()
    jtables = jm.build_token_tables()
    assert tables["tokens"].shape[0] == tm.num_templates()
    for k, v in jtables.items():
        np.testing.assert_array_equal(tables[k].numpy(), np.asarray(v), err_msg=k)
    vec = tm.mission_vec(tid, 3, 1)[None]
    words = tm.mission_word_tokens(vec, tables)[0].numpy()
    np.testing.assert_array_equal(words, np.asarray(jm.mission_word_tokens(jm.mission_vec(tid, 3, 1), jtables)))


def test_mission_space_sample_contains():
    # tests/test_tools.py's case, in both packages, seeded alike.
    from minigrid_tpu.core.mission import MissionSpace as JSpace

    assert mgt.MissionSpace is tm.MissionSpace
    args = dict(
        mission_func=lambda color, obj: f"go to the {color} {obj}",
        ordered_placeholders=[["red", "green"], ["ball", "key"]],
    )
    space, jspace = mgt.MissionSpace(**args, seed=5), JSpace(**args, seed=5)
    samples = [space.sample() for _ in range(16)]
    assert samples == [jspace.sample() for _ in range(16)]
    assert all(space.contains(s) for s in samples) and len(set(samples)) > 1
    space.seed(9), jspace.seed(9)
    assert space.sample() == jspace.sample()
    assert not space.contains("fetch me the moon") and not space.contains(3)
    const = mgt.MissionSpace(mission_func=lambda: "get to the goal")
    assert const.sample() == "get to the goal"
    assert const.contains("get to the goal") and not const.contains("other")
    assert repr(const) == repr(JSpace(const.mission_func))


def test_mission_space_eq():
    from minigrid_tpu.core.mission import MissionSpace as JSpace

    door, opened = (lambda c: f"go to the {c} door"), (lambda c: f"open the {c} door")
    for space in (mgt.MissionSpace, JSpace):
        a, b, c = space(door, [["red", "blue"]]), space(door, [["red", "blue"]]), space(opened, [["red", "blue"]])
        assert a == b and a != c and a != "go to the red door"
        assert space(door, [["red"]]) != a
    assert repr(mgt.MissionSpace(door, [["red", "blue"]])) == repr(JSpace(door, [["red", "blue"]]))


def test_registry_entry_twins_jax():
    import minigrid_tpu as mg
    from minigrid_tpu import registry as jreg

    assert treg.registered_ids() == jreg.registered_ids() == mg.registered_ids()
    for env_id in treg.registered_ids():
        cls, kwargs = treg.registry_entry(env_id)
        jcls, jkwargs = jreg.registry_entry(env_id)
        assert cls.__name__ == jcls.__name__ and kwargs == jkwargs, env_id
    with pytest.raises(KeyError):
        treg.registry_entry("MiniGrid-Unknown-v0")
    mgt.register(TURNS_ID, TurnsEnv, size=8)
    assert treg.registry_entry(TURNS_ID) == (TurnsEnv, {"size": 8})
    env = mgt.make(TURNS_ID, max_steps=64)
    assert isinstance(env, TurnsEnv) and env.max_steps == 64 and env.env_id == TURNS_ID


def test_tutorial_simple_env_runs_on_the_port():
    """The tutorial's ``SimpleEnv`` (docs/content/create_env_tutorial.md),
    written against the port.  Its template's words are outside the
    language wrappers' vocabulary, in both packages, so it is registered
    after the token tables' test."""
    from minigrid_tpu.core import mission as jm

    mission = tm.register_mission(TUTORIAL_MISSION)
    assert mission == jm.register_mission(TUTORIAL_MISSION)

    class SimpleEnv(MiniGridEnv):
        def __init__(self, size: int = 8, **kwargs):
            super().__init__(width=size, height=size, max_steps=256, **kwargs)

        def _generate(self, num_envs, generator, device):
            grid = g.wall_rect(g.empty_grid(num_envs, self.width, self.height, device), 0, 0, self.width, self.height)
            grid = g.set_cell(grid, self.width - 2, self.height - 2, GOAL_CELL)
            return new_state(
                grid, (1, 1), s_.rand_dir(generator, num_envs, device), self.max_steps, mission=tm.mission_vec(mission)
            )

    env = SimpleEnv()
    gen = torch.Generator().manual_seed(0)
    obs, state = env.reset(16, gen)
    assert obs["image"].shape == (16, 7, 7, 3)
    assert env.mission_text(state.mission[0]) == TUTORIAL_MISSION
    for _ in range(8):
        obs, state, reward, term, trunc = env.step(state, torch.randint(0, 7, (16,), generator=gen), gen)
    assert bool((state.step_count <= 8).all()) and reward.shape == (16,)


# -- The example family --------------------------------------------------------


def _posed_states(rng, n: int) -> dict:
    """Example-family states (the room, the goal at (6, 6)) with the agent
    on any interior cell, often next to the goal and facing it, ``turns``
    in [0, 4) and step counts near the limit."""
    w = h = 8
    grid = np.full((n, w, h), EMPTY_CELL, np.int32)
    grid[:, 0, :] = grid[:, -1, :] = grid[:, :, 0] = grid[:, :, -1] = WALL_CELL
    grid[:, w - 2, h - 2] = GOAL_CELL
    x, y = rng.integers(1, w - 1, n), rng.integers(1, h - 1, n)
    d = rng.integers(0, 4, n)
    near = rng.random(n) < 0.3
    side = rng.random(n) < 0.5
    x = np.where(near, np.where(side, w - 3, w - 2), x)
    y = np.where(near, np.where(side, h - 2, h - 3), y)
    d = np.where(near, np.where(side, 0, 1), d)
    x, y = np.where((x == w - 2) & (y == h - 2), 1, x), y
    max_steps = np.full(n, 64, np.int32)
    return {
        "grid": grid,
        "contains": np.zeros((n, w, h), np.int32),
        "agent_x": x.astype(np.int32),
        "agent_y": y.astype(np.int32),
        "agent_dir": d.astype(np.int32),
        "carrying": np.zeros(n, np.int32),
        "step_count": rng.integers(40, 64, n).astype(np.int32),
        "max_steps": max_steps,
        "terminated": np.zeros(n, bool),
        "truncated": np.zeros(n, bool),
        "mission": np.tile(tm.mission_vec(tm.template_id(TURNS_MISSION)).numpy(), (n, 1)),
        "extra": {"turns": rng.integers(0, MAX_TURNS, n).astype(np.int32)},
    }


def test_example_step_env_matches_jax():
    import jax
    import jax.numpy as jnp

    from minigrid_tpu.core.state import EnvState as JState
    from minigrid_tpu_torch.utils.bridge import state_from_numpy
    from torch_port_util import assert_states_equal

    n = 4096
    rng = np.random.default_rng(11)
    arrays = _posed_states(rng, n)
    # Turns half the time, so that runs of four happen.
    actions = np.where(rng.random(n) < 0.5, rng.integers(0, 2, n), rng.integers(0, 7, n)).astype(np.int32)
    jenv, tenv = _jax_turns_env(), TurnsEnv()
    fields = {k: jnp.asarray(v) for k, v in arrays.items() if k != "extra"}
    jstate = JState(**fields, rng=jnp.zeros((n, 2), jnp.uint32), extra={"turns": jnp.asarray(arrays["extra"]["turns"])})
    jnext, jreward = jax.jit(jax.vmap(jenv.step_env))(jstate, jnp.asarray(actions))
    nxt, reward = tenv.step_env(state_from_numpy(arrays, "cpu"), torch.from_numpy(actions))
    assert_states_equal(nxt, jnext, "turns step_env")
    np.testing.assert_allclose(reward.numpy(), np.asarray(jreward), rtol=1e-6, atol=0)
    dizzy = nxt.extra["turns"] >= MAX_TURNS
    assert int(dizzy.sum()) > 50 and bool(nxt.terminated[dizzy].all()) and bool((reward[dizzy] == 0).all())
    assert int((reward > 0).sum()) > 30  # goals reached keep the core step's reward
    assert int(nxt.truncated.sum()) > 0


def test_example_levels_match_jax_by_distribution():
    import jax

    n = 35 * 400
    jenv, tenv = _jax_turns_env(), TurnsEnv()
    _, st = tenv.reset(n, torch.Generator().manual_seed(3))
    jst = jax.jit(jax.vmap(jenv._generate))(jax.random.split(jax.random.PRNGKey(3), n))
    interior = {(x, y) for x in range(1, 7) for y in range(1, 7)} - {(6, 6)}
    for name, xs, ys, ds in (
        ("port", st.agent_x.numpy(), st.agent_y.numpy(), st.agent_dir.numpy()),
        ("jax", np.asarray(jst.agent_x), np.asarray(jst.agent_y), np.asarray(jst.agent_dir)),
    ):
        cells = list(zip(xs.tolist(), ys.tolist()))
        assert set(cells) == interior, name
        counts = np.array([cells.count(c) for c in sorted(interior)])
        # Each cell's count is binomial(n, 1/35): within 5 sigma of n/35.
        sigma = np.sqrt(n * (1 / 35) * (34 / 35))
        assert np.abs(counts - n / 35).max() < 5 * sigma, (name, counts)
        dir_counts = np.bincount(ds, minlength=4)
        assert np.abs(dir_counts - n / 4).max() < 5 * np.sqrt(n * 3 / 16), (name, dir_counts)
    assert bool((st.extra["turns"] == 0).all()) and int(np.asarray(jst.extra["turns"]).max()) == 0
    np.testing.assert_array_equal(st.grid[0].numpy(), np.asarray(jst.grid[0]))
    np.testing.assert_array_equal(st.mission.numpy(), np.asarray(jst.mission))


def test_example_kernels_plain_versions_run_it(tmp_path):
    # K1's plain version against JAX's cached stepper on the same cache and
    # actions, step for step; then K2's plain version held to its contracts.
    import jax
    import jax.numpy as jnp

    from torch_port_util import assert_states_equal, to_jax

    n, steps, r = 64, 48, 8
    env = TurnsEnv(max_steps=24, header=write_header(tmp_path))
    jenv = _jax_turns_env()
    jenv.max_steps = 24
    gen = torch.Generator().manual_seed(5)
    _, states = env.reset(n, gen)
    cache = env.batch_reset_cache(n, r, gen)
    actions = torch.randint(0, 7, (steps, n), generator=gen, dtype=torch.int32)
    final, total_r, done, checksum, max_used = fr.fused_rollout_core(env, states, cache, actions, True)
    jst, jcache, jused = to_jax(states), to_jax(cache), jnp.zeros(n, jnp.int32)
    jstep = jax.jit(jax.vmap(jenv.step_cached))
    jrew = jnp.zeros((), jnp.float32)
    episodes = 0
    for t in range(steps):
        _, jst, rew, term, trunc, jused = jstep(jst, jnp.asarray(actions[t].numpy()), jcache, jused)
        jrew = jrew + rew.sum()
        episodes += int((term | trunc).sum())
    assert_states_equal(final, jst, "turns fused_rollout_reference")
    assert int(done) == episodes > n and int(max_used) == int(jused.max()) <= r
    np.testing.assert_allclose(float(total_r), float(jrew), rtol=1e-5)
    assert int(final.extra["turns"].max()) < MAX_TURNS

    weights = ar.repack_actor_params(ActorCritic(64, env.num_actions, generator=gen))
    noise = ar.draw_bits(gen, (steps, env.num_actions, n), None)
    final, traj = ar.fused_actor_rollout_core(env, weights, states, cache, noise)
    assert int(traj["done"].sum()) > 0
    # The plain version on the CPU against itself: near-ties compare alike.
    ar.check_trajectory(env, weights, states, cache, noise, final, traj, ar.PLAIN_ATOL, margin=1e-4)


def test_compiled_ext_needs_the_header(tmp_path):
    bare, built = TurnsEnv(), TurnsEnv(header=write_header(tmp_path))
    assert fr.supports_fused(bare) and fr.supports_fused(built)
    assert not fr.compiled_ext(bare) and not fused_eligible(bare, "cuda")
    assert fr.compiled_ext(built) and fused_eligible(built, "cuda")
    assert not fused_eligible(built, "cpu")
    # The switches the struct is built at: see-through walls are not.
    built.see_through_walls = True
    assert not fr.compiled_ext(built)
    # A header with a built-in id is no compiled twin either.
    other = TurnsEnv(header=write_header(tmp_path))
    other.fused_ext.kernel_id = 7
    assert not fr.compiled_ext(other)
    # The learners' gate: the actor kernel takes the family too.
    assert ar.supports_fused_actor(TurnsEnv(header=write_header(tmp_path)), "cuda", 8192, 256)
    assert not ar.supports_fused_actor(bare, "cuda", 8192, 256)


def test_library_key_of_a_header(tmp_path):
    header = write_header(tmp_path)
    builtin = _build.library_path("fused_rollout")
    user = _build.library_path("fused_rollout", header, "TurnsExt")
    assert user != builtin and user.parent == builtin.parent == _build.BUILD_DIR
    assert user.name.startswith("fused_rollout-user-") and not builtin.name.startswith("fused_rollout-user-")
    assert _build.library_path("fused_rollout", header, "TurnsExt") == user  # stable
    assert _build.library_path("actor_rollout", header, "TurnsExt") not in (user, _build.library_path("actor_rollout"))
    assert _build.library_path("fused_rollout", header, "OtherExt") != user
    write_header(tmp_path, TURNS_HEADER.replace(">= 4", ">= 5"))
    edited = _build.library_path("fused_rollout", header, "TurnsExt")
    assert edited != user
    # Any file beside the header counts: it may include it.
    (tmp_path / "helpers.cuh").write_text("// helpers\n")
    assert _build.library_path("fused_rollout", header, "TurnsExt") != edited
    assert _build.library_path("fused_rollout") == builtin
    with pytest.raises(ValueError, match="kernel_struct"):
        _build.library_path("fused_rollout", header, "Turns Ext")
    with pytest.raises(FileNotFoundError):
        _build.library_path("fused_rollout", tmp_path / "missing.cuh", "TurnsExt")


def test_user_library_is_loaded_once_and_an_edited_header_rebuilt(tmp_path, monkeypatch):
    # The build and the loader stubbed (no nvcc here): what load_library
    # compiles and loads, and when.
    built, loaded = [], []

    def compile_(src, out, flags, info_key):
        built.append((src.name, out.name, info_key, [f for f in flags if f.startswith("-DMINIGRID_USER_EXT=")]))
        out.write_bytes(b"")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_compile", compile_)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: loaded.append(path) or path)
    ext_dir = tmp_path / "ext"
    ext_dir.mkdir()
    header = write_header(ext_dir)
    first = _build.load_library("fused_rollout", header, "TurnsExt")
    assert _build.load_library("fused_rollout", header, "TurnsExt") is first
    assert built == [("fused_rollout.cu", Path(first).name, "fused_rollout[TurnsExt]", ["-DMINIGRID_USER_EXT=TurnsExt"])]
    assert Path(first) == _build.library_path("fused_rollout", header, "TurnsExt")
    # Edited: this process keeps what it loaded; the next one (an emptied
    # _LIBS) builds the edit, and finds the first build again on disk.
    write_header(ext_dir, TURNS_HEADER.replace(">= 4;", ">= 5;  // five in a row"))
    assert _build.load_library("fused_rollout", header, "TurnsExt") is first and len(built) == 1
    _build._LIBS.clear()
    second = _build.load_library("fused_rollout", header, "TurnsExt")
    assert second != first and len(built) == 2 and len(loaded) == 2
    write_header(ext_dir)
    _build._LIBS.clear()
    assert _build.load_library("fused_rollout", header, "TurnsExt") == first and len(built) == 2


class _CounterTurnsExt(TurnsFusedExt):
    """A user header claiming a counter reset, which the kernels do not
    build from a user header yet."""

    covers_reset = True


def test_a_counter_reset_user_ext_raises(tmp_path):
    env = TurnsEnv(header=write_header(tmp_path))
    env.fused_ext = _CounterTurnsExt(write_header(tmp_path))
    gen = torch.Generator().manual_seed(0)
    _, states = TurnsEnv().reset(32, gen)
    actions = torch.zeros((4, 32), dtype=torch.int32)
    seeds = torch.zeros((32, 2), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 1"):
        fr.fused_rollout_core(env, states, None, actions, False, seeds)
    weights = ar.repack_actor_params(ActorCritic(64, env.num_actions, generator=gen))
    with pytest.raises(NotImplementedError, match="counter-reset ext from its own header"):
        ar.fused_actor_rollout_core(env, weights, states, None, ar.draw_bits(gen, (4, 7, 32), None), seeds)


# -- The short-chunk reset budget ------------------------------------------


@pytest.mark.parametrize("num_steps", [1, 16, 64, 128, 255, 256])
def test_short_chunks_take_the_256_step_r(num_steps):
    class Dummy:  # a non-deterministic family, by id only
        deterministic_generation = False
        expensive_reset = False

    for env_id in list(trb.MEASURED_MAX_EPISODES_256) + ["MiniGrid-Unmeasured-v0"]:
        want = trb.resets_for(Dummy(), 256, env_id)
        assert rollout_capacity(Dummy(), num_steps, "cuda", env_id, fused=True) == want, env_id
        assert trb.chunk_resets(Dummy(), num_steps, env_id) == want
    assert trb.chunk_resets(Dummy(), 512, "BabyAI-GoToLocal-v0") == trb.resets_for(Dummy(), 512, "BabyAI-GoToLocal-v0")


def test_gotodoor_short_chunk_is_covered():
    # 64 GoToDoor-5x5 envs x 16 steps, the case where the scaled R (9) fell
    # one short on the card: the default R covers every chunk of a chain.
    env = mgt.make("MiniGrid-GoToDoor-5x5-v0")
    capacity = rollout_capacity(env, 16, "cuda")
    assert capacity == trb.resets_for(env, 256) > trb.resets_for(env, 16) == 9
    gen = torch.Generator().manual_seed(19)
    _, states = env.reset(64, gen)
    states = states.replace(step_count=s_.randint(gen, 64, 0, states.max_steps))

    def chunk(carry):
        st, gen = carry
        final, reward, done, _, used = fr.fused_rollout(env, st, gen, 16, capacity, compute_obs=False)
        return (final, gen), (reward, done, used)

    observed = trb.assert_chain_covered(chunk, (states, gen), capacity, env, chunks=4)
    assert 0 < observed <= capacity


def test_ext_user_id_is_the_cuda_enum_value():
    source = (Path(fr.__file__).resolve().parent / "csrc" / "fused_ext.cuh").read_text()
    ids = dict(re.findall(r"(EXT_\w+) = (\d+)", source))
    assert int(ids["EXT_USER"]) == fx.EXT_USER
    assert fx.EXT_USER not in {int(v) for k, v in ids.items() if k != "EXT_USER"}
    exts = (Path(fr.__file__).resolve().parent / "csrc" / "exts.cuh").read_text()
    assert "case EXT_USER:\n      f(MINIGRID_USER_EXT{});" in exts and f'"{_build.USER_SHIM}"' in exts
