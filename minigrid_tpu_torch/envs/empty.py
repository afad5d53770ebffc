"""Empty room (reference: minigrid/envs/empty.py:9-114)."""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import grid as g
from minigrid_tpu_torch.core.constants import GOAL_CELL, OBJ_EMPTY
from minigrid_tpu_torch.core.env import MiniGridEnv
from minigrid_tpu_torch.core.mission import mission_vec, template_id
from minigrid_tpu_torch.core.state import EnvState, new_state
from minigrid_tpu_torch.ops import fused_ext as fx
from minigrid_tpu_torch.ops.prng import uniform_index

_MISSION_VEC = mission_vec(template_id("get to the green goal square"))


class EmptyEnv(MiniGridEnv):
    """Walled empty room, goal in the bottom-right corner, agent at a fixed
    or a random start (reference: minigrid/envs/empty.py:97-114)."""

    # The grid holds only walls and the goal, and the mission is a family
    # constant.
    fused_no_objects = True
    fused_static_mission = True

    def __init__(
        self,
        size: int = 8,
        agent_start_pos: tuple[int, int] | None = (1, 1),
        agent_start_dir: int = 0,
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
        # A fixed start gives the same level at every reset; a random start
        # is one uniform placement over a constant scaffold, which the kernel
        # regenerates itself at every episode end.
        self.deterministic_generation = agent_start_pos is not None
        if agent_start_pos is None:
            self.fused_ext = _EmptyRandomResetExt()

    def _generate(self, num_envs, generator, device) -> EnvState:
        if self.agent_start_pos is None:
            return super()._generate(num_envs, generator, device)
        w, h = self.width, self.height
        grid = g.wall_rect(g.empty_grid(num_envs, w, h, device), 0, 0, w, h)
        grid = g.set_cell(grid, w - 2, h - 2, GOAL_CELL)
        return new_state(
            grid,
            self.agent_start_pos,
            self.agent_start_dir,
            self.max_steps,
            mission=_MISSION_VEC,
        )


class _EmptyRandomResetExt(fx.FusedExt):
    """Counter-reset twin of random-start Empty (``csrc/ext/empty_random.cuh``;
    JAX: ``minigrid_tpu/envs/empty.py::_EmptyRandomResetExt``): identity
    step hooks; a fresh level is the walls-and-goal scaffold, the agent on
    a uniform empty cell (the reference's ``place_agent`` rule,
    minigrid/minigrid_env.py:313-337) and a uniform direction."""

    covers_reset = True
    kernel_id = 1
    # Its reset writes neither contents nor mission.
    kernel_switches = (True, True, None)

    def reset_block(self, env, seeds, ep_idx) -> EnvState:
        n, w, h = seeds.shape[0], env.width, env.height
        e0, e1 = fx.episode_seed(seeds, ep_idx)
        b0, b1 = fx.place_draw(e0, e1, 0)
        plane = fx.walled_plane(n, w, h, seeds.device, [(w - 2, h - 2, GOAL_CELL)])
        free = (plane & 0xFF) == OBJ_EMPTY
        count = free.sum(dim=1).clamp(min=1)
        alin = fx.nth_true_index(free, uniform_index(b0, count), 0)
        pos = torch.stack([alin // h, alin % h], dim=-1)
        return new_state(
            plane.reshape(n, w, h), pos, uniform_index(b1, 4), env.max_steps, mission=_MISSION_VEC
        )
