"""Dynamic-Obstacles (reference: minigrid/envs/dynamicobstacles.py:13-167).

An empty room with balls that walk at random before every agent action;
walking into one (or into any other blocked cell) costs -1 and ends the
episode.  The walk draws from the counter stream of ``ops/prng.py`` with a
per-episode seed carried in ``state.extra["walk_seed"]``, so the plain
hooks here, the kernel's (``csrc/ext/dynamic_obstacles.cuh``) and the JAX
package's give the same walk.  The family's generator is its counter-stream
``reset_block``, which the kernel also runs at every episode end.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core.constants import (
    COLOR_BLUE,
    EMPTY_CELL,
    GOAL_CELL,
    OBJ_BALL,
    OBJ_EMPTY,
    OBJ_GOAL,
    cell,
    dir_vec,
)
from minigrid_tpu_torch.core.env import MiniGridEnv
from minigrid_tpu_torch.core.mission import mission_vec, template_id
from minigrid_tpu_torch.core.state import EnvState, new_state
from minigrid_tpu_torch.ops import fused_ext as fx
from minigrid_tpu_torch.ops.prng import threefry2x32, to_int32, uniform_index

_MISSION_VEC = mission_vec(template_id("get to the green goal square"))
BALL_CELL = cell(OBJ_BALL, COLOR_BLUE)
# The walk seed of an episode is one threefry application of the episode's
# sub-seed with this counter ("obst", "walk"), apart from every other draw.
_WALK_TAG = (0x6F627374, 0x77616C6B)
# The kernel's obstacle slots (csrc/ext/dynamic_obstacles.cuh).
MAX_OBSTACLES = 8


def walk_obstacles(plane, width, height, agent_lin, obstacles, walk_seed, step):
    """One walk round on flat grids ``plane`` int32 [N, W*H] (cell (x, y)
    at x*H + y) of ``obstacles`` [N, n, 2], in index order: each ball
    moves to the ``uniform_index``-th free cell of its 3x3 neighbourhood,
    counted in linear order, where free means empty and not the agent's
    cell on the plane as the balls before it left it; a ball with no free
    neighbour stays.  Balls 2j and 2j+1 take the two words of
    ``threefry2x32(walk_seed, (step, j))``.  Returns (plane, obstacles)."""
    n, n_obst = obstacles.shape[:2]
    idx = torch.arange(width * height, device=plane.device)[None, :]
    xs, ys = idx // height, idx % height
    rows = torch.arange(n, device=plane.device)
    plane = plane.clone()
    moved = []
    for i in range(n_obst):
        if i % 2 == 0:
            pair = threefry2x32(walk_seed[:, 0], walk_seed[:, 1], step, i // 2)
        ox, oy = obstacles[:, i, 0].long(), obstacles[:, i, 1].long()
        olin = ox * height + oy
        free = ((plane & 0xFF) == OBJ_EMPTY) & (idx != agent_lin[:, None])
        near = (
            (xs >= (ox - 1)[:, None]) & (xs <= (ox + 1)[:, None])
            & (ys >= (oy - 1)[:, None]) & (ys <= (oy + 1)[:, None])
        )
        m = free & near
        count = m.sum(dim=1)
        nlin = fx.nth_true_index(m, uniform_index(pair[i % 2], count.clamp(min=1)), 0)
        nlin = torch.where(count > 0, nlin, olin)
        plane[rows, olin] = EMPTY_CELL
        plane[rows, nlin] = BALL_CELL
        moved.append(torch.stack([nlin // height, nlin % height], dim=-1))
    return plane, torch.stack(moved, dim=1).to(torch.int32) if moved else obstacles


class DynamicObstaclesEnv(MiniGridEnv):
    """Reference: minigrid/envs/dynamicobstacles.py:136-167.  Obstacle
    positions live in ``state.extra["obstacles"]`` (int32 [N, n, 2])."""

    # As in the JAX package; the kernels regenerate its levels themselves,
    # so its plain collector regenerates too instead of reading a cache.
    expensive_reset = True
    # Actions >= 3 become 'left', so pickup, drop and toggle never reach the
    # core step (the walk rewrites the grid in the pre-step hook, which the
    # flag allows); the mission is a family constant.
    fused_no_objects = True
    fused_static_mission = True

    def __init__(
        self,
        size: int = 8,
        agent_start_pos: tuple[int, int] | None = (1, 1),
        agent_start_dir: int = 0,
        n_obstacles: int = 4,
        max_steps: int | None = None,
        **kwargs,
    ):
        if max_steps is None:
            max_steps = 4 * size**2
        super().__init__(
            width=size, height=size, max_steps=max_steps, see_through_walls=True, **kwargs
        )
        self.agent_start_pos = None if agent_start_pos is None else tuple(agent_start_pos)
        self.agent_start_dir = int(agent_start_dir)
        self.n_obstacles = int(n_obstacles) if n_obstacles <= size / 2 + 1 else int(size / 2)
        self.fused_ext = _DynamicObstaclesFusedExt(self.n_obstacles)

    def _pre_step(self, state: EnvState, action) -> EnvState:
        n, w, h = state.grid.shape
        # "Not clear" is read before the balls move (reference :141-143).
        dx, dy = dir_vec(state.agent_dir)
        fx_ = (state.agent_x + dx).clamp(0, w - 1)
        fy_ = (state.agent_y + dy).clamp(0, h - 1)
        plane = state.grid.reshape(n, w * h)
        front = plane.gather(1, (fx_ * h + fy_).long()[:, None])[:, 0] & 0xFF
        not_clear = (front != OBJ_EMPTY) & (front != OBJ_GOAL)
        plane, obstacles = walk_obstacles(
            plane,
            w,
            h,
            (state.agent_x * h + state.agent_y).long(),
            state.extra["obstacles"],
            state.extra["walk_seed"],
            state.step_count,
        )
        extra = dict(state.extra, obstacles=obstacles, front_not_clear=not_clear)
        return state.replace(grid=plane.reshape(n, w, h), extra=extra)

    def _map_action(self, action):
        # Actions outside the 3-action space act as 'left' (reference :137-139).
        return torch.where(action >= 3, 0, action)

    def _post_step(self, prev, state, action, reward):
        collided = (action == 2) & state.extra["front_not_clear"]
        reward = torch.where(collided, -1.0, reward)
        return state.replace(terminated=state.terminated | collided), reward


class _DynamicObstaclesFusedExt(fx.FusedExt):
    """The kernel twin of the hooks above: the walk before the action, the
    >= 3 -> left remap and the collision penalty; and the counter-reset
    generator.  Scalar layout: [ox0, oy0, ..., ox(n-1), oy(n-1),
    front_not_clear, walk_seed0, walk_seed1]."""

    covers_pre_step = True
    covers_reset = True
    kernel_id = 3
    # Its reset writes neither contents nor mission.
    kernel_switches = (True, True, None)

    def __init__(self, n_obstacles: int):
        self.n = int(n_obstacles)
        self.n_scalars = 2 * self.n + 3

    def pack_extra(self, env, extra):
        obst = extra["obstacles"].to(torch.int32)
        flat = obst.reshape(obst.shape[:-2] + (2 * self.n,))
        fnc = extra["front_not_clear"].to(torch.int32)[..., None]
        return torch.cat([flat, fnc, extra["walk_seed"].to(torch.int32)], dim=-1)

    def unpack_extra(self, env, scal):
        n = self.n
        return {
            "obstacles": scal[..., : 2 * n].reshape(scal.shape[:-1] + (n, 2)),
            "front_not_clear": scal[..., 2 * n] != 0,
            "walk_seed": scal[..., 2 * n + 1 : 2 * n + 3],
        }

    def kernel_params(self, env) -> tuple[int, ...] | None:
        if self.n > MAX_OBSTACLES:
            return None
        start = env.agent_start_pos or (-1, -1)
        return (env.max_steps, self.n, 0, 0, start[0], start[1], env.agent_start_dir)

    def reset_block(self, env, seeds, ep_idx) -> EnvState:
        """The scaffold, then (random start) the agent and its direction,
        then the n balls one by one, each on a uniform empty cell that is
        not the agent's (``place_obj``, minigrid/minigrid_env.py:339-364)."""
        n, w, h = seeds.shape[0], env.width, env.height
        device = seeds.device
        e0, e1 = fx.episode_seed(seeds, ep_idx)
        random_start = env.agent_start_pos is None
        words = iter(fx.place_words(e0, e1, (2 if random_start else 0) + self.n))
        plane = fx.walled_plane(n, w, h, device, [(w - 2, h - 2, GOAL_CELL)])
        idx = torch.arange(w * h, device=device)[None, :]
        rows = torch.arange(n, device=device)

        def draw_cell(free):
            count = free.sum(dim=1).clamp(min=1)
            return fx.nth_true_index(free, uniform_index(next(words), count), 0)

        if random_start:
            agent_lin = draw_cell((plane & 0xFF) == OBJ_EMPTY)
            direction = uniform_index(next(words), 4)
        else:
            x0, y0 = env.agent_start_pos
            agent_lin = torch.full((n,), x0 * h + y0, dtype=torch.long, device=device)
            direction = env.agent_start_dir
        obstacles = []
        for _ in range(self.n):
            olin = draw_cell(((plane & 0xFF) == OBJ_EMPTY) & (idx != agent_lin[:, None]))
            plane[rows, olin] = BALL_CELL
            obstacles.append(torch.stack([olin // h, olin % h], dim=-1))
        ws0, ws1 = threefry2x32(e0, e1, *_WALK_TAG)
        extra = {
            "obstacles": torch.stack(obstacles, dim=1).to(torch.int32),
            "front_not_clear": torch.zeros(n, dtype=torch.bool, device=device),
            "walk_seed": to_int32(torch.stack([ws0, ws1], dim=-1)),
        }
        pos = torch.stack([agent_lin // h, agent_lin % h], dim=-1)
        return new_state(
            plane.reshape(n, w, h), pos, direction, env.max_steps, mission=_MISSION_VEC, extra=extra
        )
