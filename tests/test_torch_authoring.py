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
* A counter-reset example family, ``TargetBallEnv``: an 8x8 walled room
  with a ball and a box holding a second ball, of two colours, and the
  agent on uniform free cells; its mission ``"pick up the {0} ball"``
  names one of the two colours (the extra scalar); a plane marks the cells
  the agent has stood on; any pickup ends the episode, with the success
  reward for the mission's ball and 0 for anything else.  Its CUDA twin
  ``TARGET_HEADER`` regenerates the level in the kernels (``reset`` only:
  the random-policy kernel's owner-lane form), writing the grid, contents,
  mission (its template id from ``ExtParams::user``), scalar and plane.  It
  is written in JAX too (``_jax_target_env``: a ``FusedExt`` with
  ``covers_reset`` and a ``reset_block`` of ``jnp`` ops), and the two are
  held equal: levels, steps and both kernels' plain versions.
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
from minigrid_tpu_torch.core.constants import (
    EMPTY_CELL,
    GOAL_CELL,
    NUM_COLORS,
    OBJ_BALL,
    OBJ_BOX,
    OBJ_EMPTY,
    WALL_CELL,
)
from minigrid_tpu_torch.core.env import MiniGridEnv
from minigrid_tpu_torch.core.state import new_state
from minigrid_tpu_torch.core.step import success_reward
from minigrid_tpu_torch.ops.prng import uniform_index
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


TARGET_MISSION = "pick up the {0} ball"
TARGET_PARAMS = ("color",)
TARGET_ID = "MiniGrid-TargetBall-8x8-v0"

# The counter-reset family's CUDA twin: its level from placement words 0-6,
# written through the ResetCtx (all of it: this struct is built with objects,
# a per-episode mission and its plane), by `reset` alone.
TARGET_HEADER = r"""// TargetBall: pick up the ball of the mission's colour; a box holds the other.
#pragma once

#include "fused_ext.cuh"

namespace minigrid {

struct TargetBallExt : NoExt {
  static constexpr bool COUNTER_RESET = true;
  // Objects, a per-episode mission, occluding walls.
  static constexpr int SWITCHES[3] = {0, 0, 0};
  static constexpr int MAX_K = 1;
  static constexpr int NUM_PLANES = 1;

  struct Extra {
    int target;  // the mission's colour
  };

  __device__ static Extra load(const int* scal, int n, size_t, const ExtParams&) { return Extra{scal[n]}; }

  __device__ static void store(int* scal, int n, size_t, const ExtParams&, const Extra& x) {
    scal[n] = x.target;
  }

  // Room for the two objects and the agent; the mission's template id given.
  static bool params_ok(const ExtParams& p, int W, int H, int K) {
    return K == MAX_K && W >= 3 && H >= 3 && (W - 2) * (H - 2) >= 3 && p.user[0] > 0;
  }

  // The plane marks the agent's cell; a pickup ends the episode, with the
  // success reward where it is the mission's ball.
  __device__ static bool post_step(const ExtParams&, const StepCtx& ctx, float& reward, Extra& x) {
    ctx.planes[(size_t)(ctx.post.ax * ctx.H + ctx.post.ay) * ctx.N] = 1;
    const bool picked = ctx.action == ACT_PICKUP && ctx.post.carry != ctx.prev.carry;
    if (picked) {
      const bool wanted = (ctx.post.carry & 0xFF) == OBJ_BALL && ((ctx.post.carry >> 8) & 0xFF) == x.target;
      reward = wanted ? success_reward(ctx.post) : 0.0f;
    }
    return picked;
  }

  // Words 0-2 the two colours and the target, 3 ball A's cell, 4 the box's
  // (ball B inside), 5 the agent's, 6 its direction.
  __device__ static void reset(const ExtParams& p, const Words& e, const ResetCtx& rc, Scalars& s, Extra& x) {
    const int W = rc.W, H = rc.H, WH = W * H;
    const size_t N = rc.N;
    for (int k = 0; k < WH; ++k) {
      const int cx = k / H, cy = k % H;
      const bool border = cx == 0 || cy == 0 || cx == W - 1 || cy == H - 1;
      rc.grid[k * N] = border ? WALL_CELL : EMPTY_CELL;
      rc.cont[k * N] = 0;
      rc.planes[k * N] = 0;
    }
    const int ca = uniform_index(place_word(e, 0), NUM_COLORS);
    const int r = uniform_index(place_word(e, 1), NUM_COLORS - 1);
    const int cb = r + (r >= ca);
    x.target = uniform_index(place_word(e, 2), 2) ? cb : ca;
    const int a = draw_free_cell(rc.grid, N, WH, -1, place_word(e, 3));
    rc.grid[a * N] = OBJ_BALL | (ca << 8);
    const int b = draw_free_cell(rc.grid, N, WH, -1, place_word(e, 4));
    rc.grid[b * N] = OBJ_BOX | (cb << 8);
    rc.cont[b * N] = OBJ_BALL | (cb << 8);
    const int agent = draw_free_cell(rc.grid, N, WH, -1, place_word(e, 5));
    rc.planes[agent * N] = 1;
    for (int k = 0; k < rc.M; ++k) rc.mis[k * N] = k == 0 ? p.user[0] : k == 1 ? x.target : 0;
    s = fresh_scalars(agent / H, agent % H, uniform_index(place_word(e, 6), 4), p.max_steps);
  }
};

}  // namespace minigrid
"""


class TargetBallFusedExt(fx.FusedExt):
    """The port's twin of ``TargetBallExt``: ``reset_block`` is the plain
    version of its ``reset`` and ``post_step`` of its ``post_step``; the
    extra scalar is the target colour, the plane the cells the agent has
    stood on; the mission's template id is its user slot."""

    covers_reset = True
    n_scalars = 1
    n_planes = 1
    kernel_id = fx.EXT_USER
    kernel_struct = "TargetBallExt"
    kernel_switches = (False, False, False)

    def __init__(self, header=None):
        self.kernel_source = None if header is None else str(header)

    def user_params(self, env):
        return (env.mission_id,)

    def pack_extra(self, env, extra):
        return extra["target"][..., None].to(torch.int32)

    def pack_planes(self, env, extra):
        visited = extra["visited"].to(torch.int32)
        return visited.reshape(visited.shape[:-2] + (1, env.width * env.height))

    def unpack_extra(self, env, scal, planes=None):
        shape = planes.shape[:-2] + (env.width, env.height)
        return {"target": scal[..., 0], "visited": planes[..., 0, :].reshape(shape)}

    def post_step(self, env, prev, state, action, reward, scal, planes):
        carry = state.carrying
        picked = (action == Actions.pickup) & (carry != prev.carrying)
        wanted = ((carry & 0xFF) == OBJ_BALL) & (((carry >> 8) & 0xFF) == scal[:, 0])
        success = success_reward(state.step_count, state.max_steps)
        reward = torch.where(picked, torch.where(wanted, success, 0.0), reward)
        planes = planes.clone()
        rows = torch.arange(planes.shape[0], device=planes.device)
        planes[rows, 0, (state.agent_x * env.height + state.agent_y).long()] = 1
        return picked, reward, scal, planes

    def reset_block(self, env, seeds, ep_idx):
        n, w, h = seeds.shape[0], env.width, env.height
        device = seeds.device
        rows = torch.arange(n, device=device)
        e0, e1 = fx.episode_seed(seeds, ep_idx)
        words = fx.place_words(e0, e1, 7)
        grid = fx.walled_plane(n, w, h, device)
        ca = uniform_index(words[0], NUM_COLORS)
        r = uniform_index(words[1], NUM_COLORS - 1)
        cb = r + (r >= ca).long()
        target = torch.where(uniform_index(words[2], 2) == 1, cb, ca).to(torch.int32)

        def draw(word):
            free = (grid & 0xFF) == OBJ_EMPTY
            return fx.nth_true_index(free, uniform_index(word, free.sum(dim=1).clamp(min=1)), 0)

        a = draw(words[3])
        grid[rows, a] = (OBJ_BALL | (ca << 8)).to(torch.int32)
        b = draw(words[4])
        grid[rows, b] = (OBJ_BOX | (cb << 8)).to(torch.int32)
        contains = torch.zeros_like(grid)
        contains[rows, b] = (OBJ_BALL | (cb << 8)).to(torch.int32)
        agent = draw(words[5])
        visited = torch.zeros_like(grid)
        visited[rows, agent] = 1
        return new_state(
            grid.reshape(n, w, h),
            torch.stack([agent // h, agent % h], dim=-1),
            uniform_index(words[6], 4),
            env.max_steps,
            contains=contains.reshape(n, w, h),
            mission=tm.mission_rows(env.mission_id, target),
            extra={"target": target, "visited": visited.reshape(n, w, h)},
        )


class TargetBallEnv(MiniGridEnv):
    """The counter-reset example family in the port.  ``_generate`` draws
    its levels from the generator, as a family's own generator does; the
    kernels regenerate them from the counter stream (``reset_block``, or
    its header, ``header``: the path of ``TARGET_HEADER`` written to a
    file)."""

    fused_no_objects = False
    fused_static_mission = False
    # The threefry evaluations of a reset: the episode seed and the four
    # placement pairs (``tools/roofline.threefry_evaluations``).
    reset_threefry = 5

    def __init__(self, size: int = 8, max_steps: int = 256, header=None, **kwargs):
        super().__init__(width=size, height=size, max_steps=max_steps, **kwargs)
        self.fused_ext = TargetBallFusedExt(header)
        self.mission_id = tm.register_mission(TARGET_MISSION, TARGET_PARAMS)

    def _generate(self, num_envs, generator, device):
        w, h = self.width, self.height
        grid = g.wall_rect(g.empty_grid(num_envs, w, h, device), 0, 0, w, h)
        ca = s_.randint(generator, num_envs, 0, NUM_COLORS, device)
        r = s_.randint(generator, num_envs, 0, NUM_COLORS - 1, device)
        cb = r + (r >= ca).to(torch.int32)
        target = torch.where(s_.randint(generator, num_envs, 0, 2, device) == 1, cb, ca)
        pa = s_.place_obj_pos(generator, grid)
        grid = g.set_cell(grid, pa[:, 0], pa[:, 1], OBJ_BALL | (ca << 8))
        pb = s_.place_obj_pos(generator, grid)
        grid = g.set_cell(grid, pb[:, 0], pb[:, 1], OBJ_BOX | (cb << 8))
        contains = g.set_cell(torch.zeros_like(grid), pb[:, 0], pb[:, 1], OBJ_BALL | (cb << 8))
        agent = s_.place_obj_pos(generator, grid)
        visited = g.set_cell(torch.zeros_like(grid), agent[:, 0], agent[:, 1], 1)
        return new_state(
            grid,
            agent,
            s_.rand_dir(generator, num_envs, device),
            self.max_steps,
            contains=contains,
            mission=tm.mission_rows(self.mission_id, target),
            extra={"target": target, "visited": visited},
        )

    def _post_step(self, prev, state, action, reward):
        return self.fused_ext.apply_post_step(self, prev, state, action, reward)


def write_target_header(directory: Path, text: str = TARGET_HEADER) -> Path:
    path = Path(directory) / "target_ball.cuh"
    path.write_text(text)
    return path


def _jax_target_env(max_steps: int = 256):
    """The counter-reset example family in JAX: ``_generate`` through
    ``jax.random``, a ``_post_step`` override, and a ``FusedExt`` whose
    ``reset_block`` and ``post_step`` the JAX kernels trace."""
    import jax
    import jax.numpy as jnp

    from minigrid_tpu.core import grid as jg
    from minigrid_tpu.core.env import MiniGridEnv as JEnv
    from minigrid_tpu.core.env import success_reward as j_success_reward
    from minigrid_tpu.core.mission import MISSION_DIM, mission_vec, register_mission
    from minigrid_tpu.core.sampling import place_obj_pos, rand_dir, randint
    from minigrid_tpu.core.state import new_state as j_new_state
    from minigrid_tpu.ops import fused_ext as jfx
    from minigrid_tpu.ops.prng import uniform_index as j_uniform_index

    class JaxTargetBallExt(jfx.FusedExt):
        covers_reset = True
        n_scalars = 1
        n_planes = 1

        def pack_extra(self, env, extra):
            visited = extra["visited"]
            planes = visited.reshape(visited.shape[:-2] + (1, env.width * env.height))
            return extra["target"][..., None].astype(jnp.int32), planes.astype(jnp.int32)

        def unpack_extra(self, env, scal, planes):
            shape = planes.shape[:-2] + (env.width, env.height)
            return {"target": scal[..., 0], "visited": planes[..., 0, :].reshape(shape)}

        def post_step(self, ctx):
            carry = ctx.sc[jfx.ROW_CARRY]
            picked = (ctx.action == 3) & (carry != ctx.sc_prev[jfx.ROW_CARRY])
            wanted = ((carry & 0xFF) == int(OBJ_BALL)) & (((carry >> 8) & 0xFF) == ctx.scal[0])
            reward = jnp.where(picked, jnp.where(wanted, ctx.success_reward(), 0.0), ctx.reward)
            here = ctx.mask_of(ctx.sc[jfx.ROW_AX] * ctx.H + ctx.sc[jfx.ROW_AY])
            return picked, reward, ctx.scal, (jnp.where(here, 1, ctx.planes[0]),)

        def reset_block(self, env, W, H, seed0, seed1, ep_idx):
            S = jnp.asarray(seed0).shape
            e0, e1 = jfx.episode_seed(seed0, seed1, ep_idx)
            words = [w for j in range(4) for w in jfx.place_draw(e0, e1, j)]
            zero = jnp.zeros(S, jnp.int32)
            idx = jax.lax.broadcasted_iota(jnp.int32, (W * H,) + tuple(S), 0)
            g = jfx.walled_plane(W, H, S)
            ca = j_uniform_index(words[0], zero + NUM_COLORS)
            r = j_uniform_index(words[1], zero + NUM_COLORS - 1)
            cb = r + (r >= ca).astype(jnp.int32)
            target = jnp.where(j_uniform_index(words[2], zero + 2) == 1, cb, ca)

            def draw(g, word):
                free = (g & 0xFF) == int(OBJ_EMPTY)
                count = jnp.sum(free.astype(jnp.int32), axis=0)
                return jfx.nth_true_index(free, j_uniform_index(word, jnp.maximum(count, 1)), zero)

            a = draw(g, words[3])
            g = jnp.where(idx == a[None], (int(OBJ_BALL) | (ca << 8))[None], g)
            b = draw(g, words[4])
            g = jnp.where(idx == b[None], (int(OBJ_BOX) | (cb << 8))[None], g)
            c = jnp.where(idx == b[None], (int(OBJ_BALL) | (cb << 8))[None], 0)
            agent = draw(g, words[5])
            sc = {
                jfx.ROW_AX: agent // H,
                jfx.ROW_AY: agent % H,
                jfx.ROW_DIR: j_uniform_index(words[6], zero + 4),
                jfx.ROW_CARRY: zero,
                jfx.ROW_STEP: zero,
                jfx.ROW_MAX: zero + env.max_steps,
                jfx.ROW_TERM: zero,
                jfx.ROW_TRUNC: zero,
            }
            mis = jnp.stack([zero + env.mission_id, target] + [zero] * (MISSION_DIM - 2))
            return g, c, sc, mis, (target,), ((idx == agent[None]).astype(jnp.int32),)

    class JaxTargetBallEnv(JEnv):
        fused_no_objects = False
        fused_static_mission = False

        def __init__(self, size: int = 8, max_steps: int = 256, **kwargs):
            super().__init__(width=size, height=size, max_steps=max_steps, **kwargs)
            self.fused_ext = JaxTargetBallExt()
            self.mission_id = register_mission(TARGET_MISSION, TARGET_PARAMS)

        def _generate(self, key):
            ks = jax.random.split(key, 8)
            w, h = self.width, self.height
            grid = jg.wall_rect(jg.empty_grid(w, h), 0, 0, w, h)
            ca = randint(ks[0], 0, NUM_COLORS)
            r = randint(ks[1], 0, NUM_COLORS - 1)
            cb = r + (r >= ca).astype(jnp.int32)
            target = jnp.where(randint(ks[2], 0, 2) == 1, cb, ca)
            pa = place_obj_pos(ks[3], grid)
            grid = jg.set_cell(grid, pa[0], pa[1], int(OBJ_BALL) | (ca << 8))
            pb = place_obj_pos(ks[4], grid)
            grid = jg.set_cell(grid, pb[0], pb[1], int(OBJ_BOX) | (cb << 8))
            contains = jg.set_cell(jnp.zeros_like(grid), pb[0], pb[1], int(OBJ_BALL) | (cb << 8))
            agent = place_obj_pos(ks[5], grid)
            return j_new_state(
                grid=grid,
                agent_pos=agent,
                agent_dir=rand_dir(ks[6]),
                rng=ks[7],
                max_steps=self.max_steps,
                contains=contains,
                mission=mission_vec(self.mission_id, target),
                extra={"target": target, "visited": jg.set_cell(jnp.zeros_like(grid), agent[0], agent[1], 1)},
            )

        def _post_step(self, prev_state, state, action, reward):
            carry = state.carrying
            picked = (action == 3) & (carry != prev_state.carrying)
            wanted = ((carry & 0xFF) == int(OBJ_BALL)) & (((carry >> 8) & 0xFF) == state.extra["target"])
            reward = jnp.where(picked, jnp.where(wanted, j_success_reward(state), 0.0), reward)
            visited = state.extra["visited"].at[state.agent_x, state.agent_y].set(1)
            extra = {"target": state.extra["target"], "visited": visited}
            return state.replace(terminated=state.terminated | picked, extra=extra), reward

    return JaxTargetBallEnv(max_steps=max_steps)


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
    target = (TARGET_MISSION, TARGET_PARAMS)
    assert tm.register_mission(*target) == jm.register_mission(*target)
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


# -- The counter-reset example family -----------------------------------------


def _target_seeds(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return rng.integers(-(2**31), 2**31, (n, 2)).astype(np.int32), (np.arange(n) % 7).astype(np.int32)


def test_target_reset_block_matches_jax():
    import jax
    import jax.numpy as jnp

    from torch_port_util import assert_states_equal

    jenv, tenv = _jax_target_env(), TargetBallEnv()
    seeds, eps = _target_seeds(256, 31)
    ext = jenv.fused_ext
    jst = jax.jit(jax.vmap(lambda s, e: ext.reset_state(jenv, s[0], s[1], e)))(jnp.asarray(seeds), jnp.asarray(eps))
    st = tenv.fused_ext.reset_block(tenv, torch.from_numpy(seeds), torch.from_numpy(eps))
    assert_states_equal(st, jst, "TargetBall reset_block")  # contents, mission, target and plane included
    assert bool((st.mission[:, 0] == tenv.mission_id).all()) and bool((st.mission[:, 2:] == 0).all())
    assert bool((st.mission[:, 1] == st.extra["target"]).all())
    assert bool((st.contains.reshape(256, -1).count_nonzero(dim=1) == 1).all())
    assert bool((st.extra["visited"].reshape(256, -1).sum(dim=1) == 1).all())


def _target_bins(state, width: int, height: int) -> list[np.ndarray]:
    """Counts of (cell, object type and colour) over the grids, of the
    contents' (cell, colour), of the agent's (cell, direction) and of the
    target colour against ball A's."""
    n = state.grid.shape[0]
    grid = np.asarray(state.grid).reshape(n, -1)
    cells = np.arange(width * height)
    kinds = (grid & 0xFF) * 8 + ((grid >> 8) & 0xFF)
    obj = np.bincount((cells * 128 + kinds).reshape(-1), minlength=width * height * 128)
    cont = np.asarray(state.contains).reshape(n, -1)
    boxed = np.bincount((cells * 8 + ((cont >> 8) & 0xFF) * (cont != 0)).reshape(-1), minlength=width * height * 8)
    agent = np.asarray(state.agent_x) * height + np.asarray(state.agent_y)
    agent = np.bincount(agent * 4 + np.asarray(state.agent_dir), minlength=width * height * 4)
    ball = np.where((grid & 0xFF) == int(OBJ_BALL), (grid >> 8) & 0xFF, 0).max(axis=1)
    target = np.bincount(ball * 6 + np.asarray(state.extra["target"]), minlength=36)
    return [x.astype(float) for x in (obj, boxed, agent, target)]


def test_target_levels_match_both_generators_by_distribution():
    import jax

    from test_counter_reset import _assert_close_freq

    n = 4096
    jenv, tenv = _jax_target_env(), TargetBallEnv()
    seeds, eps = _target_seeds(n, 32)
    counter = tenv.fused_ext.reset_block(tenv, torch.from_numpy(seeds), torch.from_numpy(eps))
    _, port = tenv.reset(n, torch.Generator().manual_seed(33))
    jst = jax.jit(jax.vmap(jenv._generate))(jax.random.split(jax.random.PRNGKey(34), n))
    want = _target_bins(counter, 8, 8)
    for other in (port, jst):
        for got, ref in zip(_target_bins(other, 8, 8), want):
            assert (got > 0).sum() == (ref > 0).sum()
            _assert_close_freq(got, ref, n)
    # Ball A's colour and the target: the target is ball A's half the time.
    target = want[3].reshape(6, 6)
    assert np.trace(target) / n == pytest.approx(0.5, abs=0.03)


def test_target_step_env_matches_jax():
    import jax
    import jax.numpy as jnp

    from torch_port_util import assert_states_equal, to_jax

    n, steps = 4096, 16
    jenv, tenv = _jax_target_env(), TargetBallEnv()
    seeds, eps = _target_seeds(n, 35)
    st = tenv.fused_ext.reset_block(tenv, torch.from_numpy(seeds), torch.from_numpy(eps))
    jst = to_jax(st)
    rng = np.random.default_rng(36)
    # Forward, the turns, pickups and toggles: boxes open, balls are picked up.
    actions = rng.choice([0, 1, 2, 2, 3, 3, 5], (steps, n)).astype(np.int32)
    jstep = jax.jit(jax.vmap(jenv.step_env))
    picked = wanted = opened = 0
    for t in range(steps):
        jst, jr = jstep(jst, jnp.asarray(actions[t]))
        nxt, r = tenv.step_env(st, torch.from_numpy(actions[t]))
        assert_states_equal(nxt, jst, f"TargetBall step {t}")
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-6, atol=0)
        picked += int((nxt.terminated & ~st.terminated).sum())
        wanted += int((r > 0).sum())
        opened += int(((st.contains != 0) & (nxt.contains == 0) & ((nxt.grid & 0xFF) == int(OBJ_BALL))).sum())
        st = nxt
    assert picked > 200 and 0 < wanted < picked and opened > 50
    assert int(st.extra["visited"].sum()) > 2 * n


def test_target_k1_plain_version_matches_jax_kernel():
    # JAX's K1 in interpret mode with reset seeds: its counter-reset branch
    # writes contents, mission, the extra scalar and the plane.
    import jax
    import jax.numpy as jnp

    from minigrid_tpu.ops.fused_rollout import fused_rollout_core as j_fused_rollout_core
    from torch_port_util import assert_states_equal, to_port

    n, steps = 1024, 24
    jenv, tenv = _jax_target_env(max_steps=10), TargetBallEnv(max_steps=10)
    _, jstates = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(37), n))
    rng = np.random.default_rng(37)
    actions = rng.integers(0, 7, (steps, n), dtype=np.int32)
    seeds = rng.integers(-(2**31), 2**31, (n, 2)).astype(np.int32)
    jfinal, jrew, jdone, jchk, jused = j_fused_rollout_core(
        jenv, jstates, None, jnp.asarray(actions), True, True, jnp.asarray(seeds)  # interpret=True
    )
    before = fr.KERNEL_LAUNCHES
    final, rew, done, chk, used = fr.fused_rollout_core(
        tenv, to_port(jstates), None, torch.from_numpy(actions), True, torch.from_numpy(seeds)
    )
    assert fr.KERNEL_LAUNCHES == before  # CPU tensors: the plain version
    assert_states_equal(final, jfinal, "TargetBall K1")  # contents, mission and extra included
    assert int(done) == int(jdone) > n
    assert int(chk) == int(jchk)
    assert int(used) == int(jused) == 0
    np.testing.assert_allclose(float(rew), float(jrew), rtol=1e-5)
    assert float(rew) > 0 and int((final.mission[:, 1] == final.extra["target"]).sum()) == n


@pytest.fixture(scope="module")
def target_actor_case():
    """JAX's actor kernel (interpret mode) on the example family, with the
    seeds and bits it drew carried into the port's layout."""
    import jax
    import jax.numpy as jnp

    from minigrid_tpu.ops.actor_rollout import B as JAX_BLOCK
    from minigrid_tpu.ops.actor_rollout import HEAD_ROWS
    from minigrid_tpu.ops.actor_rollout import fused_actor_rollout as j_fused_actor_rollout
    from minigrid_tpu_torch.utils.bridge import state_from_numpy
    from torch_port_util import flax_params, jax_to_numpy, port_model, to_port

    n, t = 1024, 5
    env = _jax_target_env(max_steps=3)
    k_reset, k_param, key = jax.random.split(jax.random.PRNGKey(38), 3)
    _, states = jax.jit(jax.vmap(env.reset))(jax.random.split(k_reset, n))
    packed = jax.vmap(lambda s: env.observation_packed(s).reshape(-1))(states)
    _, params = flax_params(np.asarray(packed), np.asarray(states.agent_dir), seed=int(k_param[1]) % 1000)
    final, traj = jax.block_until_ready(j_fused_actor_rollout(env, params, states, key, t, 2, interpret=True))
    k_seeds, k_noise, _ = jax.random.split(key, 3)
    seeds = np.array(jax.random.bits(k_seeds, (n, 2), jnp.uint32).astype(jnp.int32))
    bits = np.asarray(jax.random.bits(k_noise, (n // JAX_BLOCK, t, HEAD_ROWS, JAX_BLOCK), jnp.uint32).astype(jnp.int32))
    noise = bits.transpose(1, 2, 0, 3).reshape(t, HEAD_ROWS, n)[:, : env.num_actions]
    return {
        "env": TargetBallEnv(max_steps=3),
        "weights": ar.repack_actor_params(port_model(params)),
        "states": to_port(states),
        "seeds": torch.from_numpy(seeds),
        "noise": torch.from_numpy(np.ascontiguousarray(noise)),
        "final": state_from_numpy(jax_to_numpy(final)),
        "traj": {k: torch.from_numpy(np.array(v)) for k, v in traj.items()},
    }


def test_target_jax_actor_kernel_meets_the_port_contracts(target_actor_case):
    c = target_actor_case
    traj = c["traj"]
    assert int(traj["done"].sum()) >= traj["done"].shape[1]  # every env reset at least once
    err, ties = ar.check_trajectory(
        c["env"], c["weights"], c["states"], None, c["noise"], c["final"], traj, reset_seeds=c["seeds"]
    )
    assert err <= 2e-2 and ties <= 0.01 * traj["done"].numel()


def test_target_actor_reference_meets_the_contracts(target_actor_case):
    c = target_actor_case
    before = ar.KERNEL_LAUNCHES
    final, traj = ar.fused_actor_rollout_core(c["env"], c["weights"], c["states"], None, c["noise"], c["seeds"])
    assert ar.KERNEL_LAUNCHES == before  # CPU tensors: the plain version
    ar.check_trajectory(
        c["env"], c["weights"], c["states"], None, c["noise"], final, traj, reset_seeds=c["seeds"]
    )
    same = (traj["action"][0] == c["traj"]["action"][0]).float().mean()
    assert float(same) >= 0.99
    np.testing.assert_array_equal(traj["obs"][0].numpy(), c["traj"]["obs"][0].numpy())


class _FakeLibrary:
    """A built user library's ``minigrid_ext_layout``, without ``nvcc``."""

    def __init__(self, layout):
        self.layout = layout

    def minigrid_ext_layout(self, ext_id, out):
        for i, v in enumerate(self.layout):
            out[i] = v
        return int(ext_id == fx.EXT_USER)


# TargetBallExt's MAX_K, NUM_PLANES, SWITCHES, COUNTER_RESET and PRE_STEP.
TARGET_LAYOUT = (1, 1, 0, 0, 0, 1, 0)


@pytest.mark.parametrize(
    "layout, ok",
    [
        (TARGET_LAYOUT, True),
        (TARGET_LAYOUT[:5] + (0, 0), False),  # a header without COUNTER_RESET
        (TARGET_LAYOUT[:5] + (1, 1), False),  # a header with PRE_STEP
    ],
)
def test_kernel_library_holds_counter_reset_and_pre_step_to_the_twin(tmp_path, monkeypatch, layout, ok):
    env = TargetBallEnv(header=write_target_header(tmp_path))
    monkeypatch.setattr(fr, "load_library", lambda name, header=None, struct=None: _FakeLibrary(layout))
    for name in ("fused_rollout", "actor_rollout"):
        if ok:
            assert isinstance(fr.kernel_library(name, env), _FakeLibrary)
        else:
            with pytest.raises(ValueError, match="COUNTER_RESET, PRE_STEP"):
                fr.kernel_library(name, env)


def test_user_slots_are_bounded(tmp_path):
    env = TargetBallEnv(header=write_target_header(tmp_path))
    assert fx.user_slots(env.fused_ext, env) == (env.mission_id, 0, 0, 0)
    assert fx.user_slots(TurnsFusedExt(), env) == (0,) * fx.USER_SLOTS

    class TooMany(TargetBallFusedExt):
        def user_params(self, env):
            return tuple(range(fx.USER_SLOTS + 1))

    env.fused_ext = TooMany()
    with pytest.raises(ValueError, match="the kernels hold 4"):
        fx.user_slots(env.fused_ext, env)
    _, states = env.reset(32, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="the kernels hold 4"):
        fr.ext_buffers(env, states, None, torch.zeros((32, 2), dtype=torch.int32), "fused_rollout")


def test_the_gates_take_the_counter_reset_family(tmp_path):
    bare, built = TargetBallEnv(), TargetBallEnv(header=write_target_header(tmp_path))
    assert fr.supports_fused(built) and fr.counter_reset(built)
    assert fr.compiled_ext(built) and fused_eligible(built, "cuda") and not fr.compiled_ext(bare)
    assert ar.supports_fused_actor(built, "cuda", 8192, 256) and not ar.supports_fused_actor(bare, "cuda", 8192, 256)
    built.see_through_walls = True  # the struct is built with occluding walls only
    assert not fr.compiled_ext(built)


def test_make_ppo_on_the_target_family_draws_seeds_and_no_cache(tmp_path, monkeypatch):
    from minigrid_tpu_torch.ops.prng import draw_seeds
    from minigrid_tpu_torch.rl.ppo import PPOConfig, make_ppo

    env = TargetBallEnv(max_steps=12, header=write_target_header(tmp_path))

    def no_cache(*args, **kwargs):
        raise AssertionError("a counter-reset family draws no reset cache")

    monkeypatch.setattr(env, "batch_reset_cache", no_cache)
    init_fn, train_step = make_ppo(env, PPOConfig(rollout_steps=8, num_minibatches=2), hidden=64)
    assert train_step.resets.can_replay is False
    state, metrics = train_step(init_fn(torch.Generator().manual_seed(0), 64))
    assert all(bool(torch.isfinite(metrics[k])) for k in ("pg_loss", "value_loss", "entropy"))
    # The actor kernel's collection (the learners' route on the card): the
    # seeds, then the bits, and the plain version on them.
    gen = torch.Generator().manual_seed(5)
    model = ActorCritic(64, env.num_actions, generator=gen)
    snapshot = gen.get_state()
    final, traj = ar.fused_actor_rollout(env, model, state.env_states, gen, 6)
    gen.set_state(snapshot)
    seeds = draw_seeds(gen, 64, "cpu")
    noise = ar.draw_bits(gen, (6, env.num_actions, 64), None)
    want_final, want = ar.actor_rollout_reference(
        env, ar.repack_actor_params(model), state.env_states, None, noise, seeds
    )
    for k in want:
        assert torch.equal(traj[k], want[k]), k
    for k, v in want_final.extra.items():
        assert torch.equal(final.extra[k], v), k
    assert torch.equal(final.mission, want_final.mission) and torch.equal(final.contains, want_final.contains)


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
