"""GoToDoor (reference: minigrid/envs/gotodoor.py:66-149)."""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import grid as g
from minigrid_tpu_torch.core import sampling as s
from minigrid_tpu_torch.core.constants import OBJ_DOOR, SORTED_COLOR_IDX, STATE_CLOSED, WALL_CELL, cell
from minigrid_tpu_torch.core.env import MiniGridEnv
from minigrid_tpu_torch.core.mission import mission_rows, template_id
from minigrid_tpu_torch.core.state import EnvState, new_state
from minigrid_tpu_torch.envs.gotoobject import GoToTargetFusedExt, permutation_prefix

_MISSION = template_id("go to the {0} door", ("color",))


class GoToDoorEnv(MiniGridEnv):
    """A room of random size in [5, size]^2 with a door of a distinct color
    in each wall; ``done`` next to the target door rewards (reference
    :91-149).  Cells outside the room stay empty, as in the reference."""

    expensive_reset = True
    fused_ext = GoToTargetFusedExt()

    def __init__(self, size: int = 5, max_steps: int | None = None, **kwargs):
        if size < 5:
            raise ValueError(f"GoToDoor needs size >= 5, got {size}")
        if max_steps is None:
            max_steps = 4 * size**2
        super().__init__(width=size, height=size, max_steps=max_steps, see_through_walls=True, **kwargs)

    def _generate(self, num_envs: int, generator: torch.Generator | None, device) -> EnvState:
        n, w, h = num_envs, self.width, self.height
        rw = s.randint(generator, n, 5, w + 1, device)
        rh = s.randint(generator, n, 5, h + 1, device)
        grid = g.empty_grid(n, w, h, device)
        outer = g.rect_mask(w, h, 0, 0, rw, rh)
        inner = g.rect_mask(w, h, 1, 1, rw - 2, rh - 2)
        grid = g.put(grid, outer & ~inner, WALL_CELL)
        # One door in the top, bottom, left and right walls (reference :103-107).
        zero = torch.zeros(n, dtype=torch.int32, device=device)
        door_x = torch.stack([s.randint(generator, n, 2, rw - 2), s.randint(generator, n, 2, rw - 2), zero, rw - 1], 1)
        door_y = torch.stack([zero, rh - 1, s.randint(generator, n, 2, rh - 2), s.randint(generator, n, 2, rh - 2)], 1)
        # Four distinct colors in uniform order (the reference's rejection
        # loop :110-115 is a uniform permutation prefix).
        order = permutation_prefix(generator, n, len(SORTED_COLOR_IDX), 4, device)
        colors = torch.tensor(SORTED_COLOR_IDX, dtype=torch.int32, device=device)[order]
        for i in range(4):
            grid = g.set_cell(grid, door_x[:, i], door_y[:, i], cell(OBJ_DOOR, colors[:, i], STATE_CLOSED))
        agent = s.place_obj_pos(generator, grid, size=(rw, rh))
        agent_dir = s.rand_dir(generator, n, device)
        target = s.randint(generator, n, 0, 4, device).long()
        rows = torch.arange(n, device=device)
        return new_state(
            grid,
            agent,
            agent_dir,
            self.max_steps,
            mission=mission_rows(_MISSION, colors[rows, target]),
            extra={"target_pos": torch.stack([door_x[rows, target], door_y[rows, target]], dim=-1)},
        )

    def _post_step(self, prev, state, action, reward):
        return self.fused_ext.apply_post_step(self, prev, state, action, reward)
