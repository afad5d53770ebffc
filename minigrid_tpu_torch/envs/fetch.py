"""Fetch (reference: minigrid/envs/fetch.py:10-176)."""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import grid as g
from minigrid_tpu_torch.core import sampling as s
from minigrid_tpu_torch.core.constants import OBJ_BALL, OBJ_KEY, SORTED_COLOR_IDX, cell
from minigrid_tpu_torch.core.env import MiniGridEnv
from minigrid_tpu_torch.core.mission import mission_rows, template_id
from minigrid_tpu_torch.core.state import EnvState, new_state
from minigrid_tpu_torch.core.step import success_reward
from minigrid_tpu_torch.ops import fused_ext as fx

# The five mission syntaxes (reference :78-84, :149-159).
_SYNTAX = ("get a", "go get a", "fetch a", "go fetch a", "you must fetch a")
_MISSIONS = tuple(template_id(f"{syntax} {{0}} {{1}}", ("color", "type")) for syntax in _SYNTAX)


class FetchFusedExt(fx.CachedExt):
    """Fetch's step overlay (``csrc/ext/fetch.cuh``; JAX:
    ``minigrid_tpu/envs/fetch.py::_FetchFusedExt``): any pickup ends the
    episode, rewarded only where the carried (type, color) is the target.
    Extra scalars: the target's type and color, blended from the reset
    cache."""

    n_scalars = 2
    kernel_id = 5
    # Objects, a per-episode mission, see-through walls.
    kernel_switches = (False, False, True)

    def pack_extra(self, env, extra):
        return torch.stack([extra["target_type"], extra["target_color"]], dim=-1).to(torch.int32)

    def unpack_extra(self, env, scal):
        return {"target_type": scal[..., 0], "target_color": scal[..., 1]}

    def post_step(self, env, prev, state, action, reward, scal):
        carry = state.carrying
        carrying = (carry & 0xFF) != 0
        match = ((carry & 0xFF) == scal[..., 0]) & (((carry >> 8) & 0xFF) == scal[..., 1])
        success = success_reward(state.step_count, state.max_steps)
        reward = torch.where(carrying & match, success, torch.where(carrying, 0.0, reward))
        return carrying, reward, scal


class FetchEnv(MiniGridEnv):
    """N random keys and balls (duplicates allowed); picking up the target
    rewards, picking up anything ends the episode (reference :108-176)."""

    expensive_reset = True
    fused_ext = FetchFusedExt()

    def __init__(self, size: int = 8, numObjs: int = 3, max_steps: int | None = None, **kwargs):
        if max_steps is None:
            max_steps = 5 * size**2
        super().__init__(width=size, height=size, max_steps=max_steps, see_through_walls=True, **kwargs)
        self.num_objs = int(numObjs)

    def _generate(self, num_envs: int, generator: torch.Generator | None, device) -> EnvState:
        n, w, h = num_envs, self.width, self.height
        grid = g.wall_rect(g.empty_grid(n, w, h, device), 0, 0, w, h)
        color_table = torch.tensor(SORTED_COLOR_IDX, dtype=torch.int32, device=device)
        types, colors = [], []
        for _ in range(self.num_objs):
            # Independent draws (reference :120-136).
            t = torch.where(s.randint(generator, n, 0, 2, device) == 0, OBJ_KEY, OBJ_BALL).to(torch.int32)
            c = color_table[s.randint(generator, n, 0, len(SORTED_COLOR_IDX), device).long()]
            pos = s.place_obj_pos(generator, grid)
            grid = g.set_cell(grid, pos[:, 0], pos[:, 1], cell(t, c))
            types.append(t)
            colors.append(c)
        agent = s.place_obj_pos(generator, grid)
        agent_dir = s.rand_dir(generator, n, device)
        target = s.randint(generator, n, 0, self.num_objs, device).long()
        syntax = s.randint(generator, n, 0, len(_SYNTAX), device).long()
        rows = torch.arange(n, device=device)
        t_type, t_color = torch.stack(types, 1)[rows, target], torch.stack(colors, 1)[rows, target]
        missions = torch.tensor(_MISSIONS, dtype=torch.int32, device=device)
        return new_state(
            grid,
            agent,
            agent_dir,
            self.max_steps,
            mission=mission_rows(missions[syntax], t_color, t_type),
            extra={"target_type": t_type, "target_color": t_color},
        )

    def _post_step(self, prev, state, action, reward):
        return self.fused_ext.apply_post_step(self, prev, state, action, reward)
