"""PutNear (reference: minigrid/envs/putnear.py:10-200).

Counterpart of ``minigrid_tpu/envs/putnear.py``.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import grid as g
from minigrid_tpu_torch.core import sampling as s_
from minigrid_tpu_torch.core.actions import Actions
from minigrid_tpu_torch.core.constants import cell, dir_vec
from minigrid_tpu_torch.core.env import MiniGridEnv
from minigrid_tpu_torch.core.mission import mission_rows, template_id
from minigrid_tpu_torch.core.state import EnvState, new_state
from minigrid_tpu_torch.core.step import success_reward
from minigrid_tpu_torch.envs.gotoobject import _COMBO_COLOR, _COMBO_TYPE, permutation_prefix
from minigrid_tpu_torch.ops import fused_ext as fx

_MISSION = template_id("put the {0} {1} near the {2} {3}", ("color", "type", "color", "type"))


class PutNearFusedExt(fx.CachedExt):
    """PutNear's step overlay (``csrc/ext/put_near.cuh``; JAX:
    ``minigrid_tpu/envs/putnear.py::_PutNearFusedExt``): a pickup that
    leaves the agent carrying anything but the object to move ends the
    episode, and so does any drop attempt while carrying; a drop that lands
    Chebyshev-adjacent to the target succeeds.  The landing cell is the one
    in front of the post-step pose, unclipped.  Extra scalars: the move
    object's type and color and the target's x and y, blended from the
    reset cache."""

    n_scalars = 4
    kernel_id = 11
    # Objects, a per-episode mission, see-through walls.
    kernel_switches = (False, False, True)

    def pack_extra(self, env, extra):
        kind = torch.stack([extra["move_type"], extra["move_color"]], dim=-1)
        return torch.cat([kind, extra["target_pos"]], dim=-1).to(torch.int32)

    def unpack_extra(self, env, scal):
        return {"move_type": scal[..., 0], "move_color": scal[..., 1], "target_pos": scal[..., 2:4]}

    def post_step(self, env, prev, state, action, reward, scal):
        carry = state.carrying
        carrying = (carry & 0xFF) != 0
        wrong = carrying & (((carry & 0xFF) != scal[:, 0]) | (((carry >> 8) & 0xFF) != scal[:, 1]))
        wrong_pickup = (action == Actions.pickup) & wrong
        pre_carrying = (prev.carrying & 0xFF) != 0
        dx, dy = dir_vec(state.agent_dir)
        fx_, fy_ = state.agent_x + dx, state.agent_y + dy
        near_target = ((fx_ - scal[:, 2]).abs() <= 1) & ((fy_ - scal[:, 3]).abs() <= 1)
        drop_attempt = (action == Actions.drop) & pre_carrying
        success = drop_attempt & ~carrying & near_target
        reward = torch.where(success, success_reward(state.step_count, state.max_steps), reward)
        return wrong_pickup | drop_attempt, reward, scal


class PutNearEnv(MiniGridEnv):
    """N distinct objects, none placed next to another; pick up the one to
    move and drop it next to the target (reference: minigrid/envs/putnear.py:103-200)."""

    expensive_reset = True
    fused_ext = PutNearFusedExt()

    def __init__(self, size: int = 6, numObjs: int = 2, max_steps: int | None = None, **kwargs):
        if max_steps is None:
            max_steps = 5 * size
        super().__init__(width=size, height=size, max_steps=max_steps, see_through_walls=True, **kwargs)
        self.num_objs = int(numObjs)

    def _generate(self, num_envs: int, generator: torch.Generator | None, device) -> EnvState:
        w, h, n, k = self.width, self.height, num_envs, self.num_objs
        grid = g.wall_rect(g.empty_grid(n, w, h, device), 0, 0, w, h)
        combo = permutation_prefix(generator, n, len(_COMBO_TYPE), k, device)
        types = torch.tensor(_COMBO_TYPE, dtype=torch.int32, device=device)[combo]
        colors = torch.tensor(_COMBO_COLOR, dtype=torch.int32, device=device)[combo]
        near = torch.zeros((n, w, h), dtype=torch.bool, device=device)
        positions = []
        for i in range(k):
            # Not within Chebyshev distance 1 of a placed object (reference :118-124).
            pos = s_.place_obj_pos(generator, grid, reject=near)
            grid = g.set_cell(grid, pos[:, 0], pos[:, 1], cell(types[:, i], colors[:, i]))
            near = near | s_.neighbor_mask(w, h, pos)
            positions.append(pos)
        agent = s_.place_obj_pos(generator, grid)
        agent_dir = s_.rand_dir(generator, n, device)
        move = s_.randint(generator, n, 0, k, device)
        # The target: uniform over the other objects (reference :162-165).
        target = ((move + s_.randint(generator, n, 1, k, device)) % k).long()
        move = move.long()
        rows = torch.arange(n, device=device)
        m_type, m_color = types[rows, move], colors[rows, move]
        t_type, t_color = types[rows, target], colors[rows, target]
        return new_state(
            grid,
            agent,
            agent_dir,
            self.max_steps,
            mission=mission_rows(_MISSION, m_color, m_type, t_color, t_type),
            extra={"move_type": m_type, "move_color": m_color, "target_pos": torch.stack(positions, dim=1)[rows, target]},
        )

    def _post_step(self, prev, state, action, reward):
        return self.fused_ext.apply_post_step(self, prev, state, action, reward)
