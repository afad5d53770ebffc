"""GoToObject (reference: minigrid/envs/gotoobject.py:66-160), and the ext
it shares with GoToDoor."""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import grid as g
from minigrid_tpu_torch.core import sampling as s
from minigrid_tpu_torch.core.actions import Actions
from minigrid_tpu_torch.core.constants import OBJ_BALL, OBJ_BOX, OBJ_KEY, SORTED_COLOR_IDX, cell
from minigrid_tpu_torch.core.env import MiniGridEnv
from minigrid_tpu_torch.core.mission import mission_rows, template_id
from minigrid_tpu_torch.core.state import EnvState, new_state
from minigrid_tpu_torch.core.step import success_reward
from minigrid_tpu_torch.ops import fused_ext as fx

_MISSION = template_id("go to the {0} {1}", ("color", "type"))
# The 18 (type, color) pairs; the reference's rejection loop for distinct
# pairs (:107-113) draws a uniform prefix of a permutation of them.
_COMBO_TYPE = tuple(t for t in (OBJ_KEY, OBJ_BALL, OBJ_BOX) for _ in SORTED_COLOR_IDX)
_COMBO_COLOR = SORTED_COLOR_IDX * 3


def permutation_prefix(generator: torch.Generator | None, n: int, size: int, k: int, device) -> torch.Tensor:
    """int64 [n, k]: the first ``k`` entries of a uniform permutation of
    ``range(size)`` per row (the order of ``size`` uniform 62-bit keys)."""
    keys = torch.randint(0, 2**62, (n, size), generator=generator, device=device, dtype=torch.int64)
    return keys.argsort(dim=1)[:, :k]


class GoToTargetFusedExt(fx.CachedExt):
    """GoToObject's and GoToDoor's step overlay (``csrc/ext/goto_target.cuh``;
    JAX: ``minigrid_tpu/envs/gotoobject.py::GoToTargetFusedExt``): ``done``
    next to the target succeeds; ``toggle`` or ``done`` ends the episode.
    Extra scalars: the target's x and y, blended from the reset cache."""

    n_scalars = 2
    kernel_id = 4
    # Objects, a per-episode mission, see-through walls: GoToObject, GoToDoor.
    kernel_switches = (False, False, True)

    def pack_extra(self, env, extra):
        return extra["target_pos"].to(torch.int32)

    def unpack_extra(self, env, scal):
        return {"target_pos": scal}

    def post_step(self, env, prev, state, action, reward, scal):
        ax, ay = state.agent_x, state.agent_y
        tx, ty = scal[..., 0], scal[..., 1]
        next_to = ((ax == tx) & ((ay - ty).abs() == 1)) | ((ay == ty) & ((ax - tx).abs() == 1))
        is_done = action == Actions.done
        reward = torch.where(is_done & next_to, success_reward(state.step_count, state.max_steps), reward)
        return (action == Actions.toggle) | is_done, reward, scal


class GoToObjectEnv(MiniGridEnv):
    """N distinct random objects; ``done`` next to the target rewards, and
    ``toggle`` or ``done`` ends the episode (reference :94-160)."""

    expensive_reset = True
    fused_ext = GoToTargetFusedExt()

    def __init__(self, size: int = 6, numObjs: int = 2, max_steps: int | None = None, **kwargs):
        if max_steps is None:
            max_steps = 5 * size**2
        super().__init__(width=size, height=size, max_steps=max_steps, see_through_walls=True, **kwargs)
        self.num_objs = int(numObjs)

    def _generate(self, num_envs: int, generator: torch.Generator | None, device) -> EnvState:
        n, w, h, k = num_envs, self.width, self.height, self.num_objs
        grid = g.wall_rect(g.empty_grid(n, w, h, device), 0, 0, w, h)
        combo = permutation_prefix(generator, n, len(_COMBO_TYPE), k, device)
        types = torch.tensor(_COMBO_TYPE, dtype=torch.int32, device=device)[combo]
        colors = torch.tensor(_COMBO_COLOR, dtype=torch.int32, device=device)[combo]
        positions = []
        for i in range(k):
            pos = s.place_obj_pos(generator, grid)
            grid = g.set_cell(grid, pos[:, 0], pos[:, 1], cell(types[:, i], colors[:, i]))
            positions.append(pos)
        agent = s.place_obj_pos(generator, grid)
        agent_dir = s.rand_dir(generator, n, device)
        target = s.randint(generator, n, 0, k, device).long()
        rows = torch.arange(n, device=device)
        return new_state(
            grid,
            agent,
            agent_dir,
            self.max_steps,
            mission=mission_rows(_MISSION, colors[rows, target], types[rows, target]),
            extra={"target_pos": torch.stack(positions, dim=1)[rows, target]},
        )

    def _post_step(self, prev, state, action, reward):
        return self.fused_ext.apply_post_step(self, prev, state, action, reward)
