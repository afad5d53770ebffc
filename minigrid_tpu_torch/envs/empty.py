"""Empty room with a fixed start (reference: minigrid/envs/empty.py:9-114)."""

from __future__ import annotations

from minigrid_tpu_torch.core import grid as g
from minigrid_tpu_torch.core.constants import GOAL_CELL
from minigrid_tpu_torch.core.env import MiniGridEnv
from minigrid_tpu_torch.core.mission import mission_vec, template_id
from minigrid_tpu_torch.core.state import EnvState, new_state

_MISSION_VEC = mission_vec(template_id("get to the green goal square"))


class EmptyEnv(MiniGridEnv):
    """Walled empty room, goal in the bottom-right corner, agent at a fixed
    start (reference: minigrid/envs/empty.py:97-114)."""

    # The level is the same for every reset, the grid holds only walls and
    # the goal, and the mission is a family constant.
    deterministic_generation = True
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
        if agent_start_pos is None:
            raise NotImplementedError(
                "Empty-Random (random start, regenerated in-kernel by a counter-reset "
                "ext) comes with the second slice of the port (ROADMAP.md queue 1, item 6)"
            )
        if max_steps is None:
            max_steps = 4 * size**2
        super().__init__(
            width=size, height=size, max_steps=max_steps, see_through_walls=True, **kwargs
        )
        self.agent_start_pos = tuple(agent_start_pos)
        self.agent_start_dir = int(agent_start_dir)

    def _generate(self, num_envs, generator, device) -> EnvState:
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
