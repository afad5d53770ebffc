"""Memory (reference: minigrid/envs/memory.py:12-165).

Counterpart of ``minigrid_tpu/envs/memory.py``.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import grid as g
from minigrid_tpu_torch.core import sampling as s_
from minigrid_tpu_torch.core.actions import Actions
from minigrid_tpu_torch.core.constants import COLOR_GREEN, OBJ_BALL, OBJ_KEY, WALL_CELL, cell
from minigrid_tpu_torch.core.env import MiniGridEnv
from minigrid_tpu_torch.core.mission import mission_vec, template_id
from minigrid_tpu_torch.core.state import EnvState, new_state
from minigrid_tpu_torch.core.step import success_reward
from minigrid_tpu_torch.ops import fused_ext as fx

_MISSION = mission_vec(template_id("go to the matching object at the end of the hallway"))


class MemoryFusedExt(fx.CachedExt):
    """Memory's hooks (``csrc/ext/memory.cuh``; JAX:
    ``minigrid_tpu/envs/memory.py::_MemoryFusedExt``): pickup acts as toggle,
    and reaching the success or the failure cell ends the episode, rewarded
    only at the success cell.  Extra scalars: the two cells' x and y,
    blended from the reset cache."""

    n_scalars = 4
    kernel_id = 10
    # Objects, a per-episode mission, occluding walls.
    kernel_switches = (False, False, False)

    def pack_extra(self, env, extra):
        return torch.cat([extra["success_pos"], extra["failure_pos"]], dim=-1).to(torch.int32)

    def unpack_extra(self, env, scal):
        return {"success_pos": scal[..., 0:2], "failure_pos": scal[..., 2:4]}

    def map_action(self, action: torch.Tensor) -> torch.Tensor:
        return torch.where(action == Actions.pickup, Actions.toggle, action).to(torch.int32)

    def post_step(self, env, prev, state, action, reward, scal):
        ax, ay = state.agent_x, state.agent_y
        at_success = (ax == scal[:, 0]) & (ay == scal[:, 1])
        at_failure = (ax == scal[:, 2]) & (ay == scal[:, 3])
        success = success_reward(state.step_count, state.max_steps)
        reward = torch.where(at_success, success, torch.where(at_failure, 0.0, reward))
        return at_success | at_failure, reward, scal


class MemoryEnv(MiniGridEnv):
    """A cue object in the start room and two candidates where the hallway
    splits; walking to the one that matches the cue succeeds
    (reference: minigrid/envs/memory.py:94-165)."""

    fused_ext = MemoryFusedExt()

    def __init__(self, size: int = 13, random_length: bool = False, max_steps: int | None = None, **kwargs):
        if size % 2 != 1:
            raise ValueError(f"Memory's size must be odd, got {size}")
        if max_steps is None:
            max_steps = 5 * size**2
        super().__init__(width=size, height=size, max_steps=max_steps, see_through_walls=False, **kwargs)
        self.random_length = bool(random_length)

    def _generate(self, num_envs: int, generator: torch.Generator | None, device) -> EnvState:
        w, h, n = self.width, self.height, num_envs
        xs, ys = g.coord_grids(w, h, device)
        mid = h // 2
        upper, lower = mid - 2, mid + 2
        if self.random_length:
            hallway_end = s_.randint(generator, n, 4, w - 2, device)
        else:
            hallway_end = torch.full((n,), w - 3, dtype=torch.int32, device=device)
        end = hallway_end[:, None, None]
        grid = g.wall_rect(g.empty_grid(n, w, h, device), 0, 0, w, h)
        # The start room (reference :112-116).
        grid = g.put(grid, g.horz_wall_mask(w, h, 1, upper, 4, device), WALL_CELL)
        grid = g.put(grid, g.horz_wall_mask(w, h, 1, lower, 4, device), WALL_CELL)
        grid = g.set_cell(grid, 4, upper + 1, WALL_CELL)
        grid = g.set_cell(grid, 4, lower - 1, WALL_CELL)
        # The horizontal hallway, x in [5, hallway_end) (reference :119-121).
        hall = (xs >= 5) & (xs < end)
        grid = g.put(grid, hall & ((ys == upper + 1) | (ys == lower - 1)), WALL_CELL)
        # The vertical hallway (reference :124-127).
        grid = g.put(grid, ((xs == end) & (ys != mid)) | (xs == end + 2), WALL_CELL)
        agent_x = s_.randint(generator, n, 1, hallway_end + 1)
        # The cue and the candidates, all green (reference :134-141).
        cue = torch.where(s_.randint(generator, n, 0, 2, device) == 0, OBJ_KEY, OBJ_BALL).int()
        grid = g.set_cell(grid, 1, mid - 1, cell(cue, COLOR_GREEN))
        first_is_ball = s_.randint(generator, n, 0, 2, device) == 0
        obj0 = torch.where(first_is_ball, OBJ_BALL, OBJ_KEY).int()
        obj1 = torch.where(first_is_ball, OBJ_KEY, OBJ_BALL).int()
        grid = g.set_cell(grid, hallway_end + 1, mid - 2, cell(obj0, COLOR_GREEN))
        grid = g.set_cell(grid, hallway_end + 1, mid + 2, cell(obj1, COLOR_GREEN))
        # The success and failure cells, one step inside (reference :144-149).
        above = torch.stack([hallway_end + 1, torch.full_like(hallway_end, mid - 1)], dim=-1)
        below = torch.stack([hallway_end + 1, torch.full_like(hallway_end, mid + 1)], dim=-1)
        match0 = (cue == obj0)[:, None]
        return new_state(
            grid,
            torch.stack([agent_x, torch.full_like(agent_x, mid)], dim=-1),
            0,
            self.max_steps,
            mission=_MISSION,
            extra={"success_pos": torch.where(match0, above, below), "failure_pos": torch.where(match0, below, above)},
        )

    def _map_action(self, action):
        return self.fused_ext.map_action(action)

    def _post_step(self, prev, state, action, reward):
        return self.fused_ext.apply_post_step(self, prev, state, action, reward)
