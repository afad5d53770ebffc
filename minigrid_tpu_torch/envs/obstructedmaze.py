"""ObstructedMaze v0 and v1 (reference: minigrid/envs/obstructedmaze.py:9-271,
minigrid/envs/obstructedmaze_v1.py:9-99).

Counterpart of ``minigrid_tpu/envs/obstructedmaze.py``.  The JAX package
builds this family's reset cache from one flat pool of levels
(``flat_reset_pool``), a layout chosen for the TPU; here every family's
cache comes from ``core/env.batch_reset_cache``'s chunks, and the kernels
read it where it lies.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import grid as g
from minigrid_tpu_torch.core import sampling as s_
from minigrid_tpu_torch.core.actions import Actions
from minigrid_tpu_torch.core.constants import (
    COLOR_BLUE,
    COLOR_GREEN,
    COLOR_GREY,
    OBJ_BALL,
    OBJ_BOX,
    OBJ_KEY,
    SORTED_COLOR_IDX,
    cell,
)
from minigrid_tpu_torch.core.mission import mission_vec, template_id
from minigrid_tpu_torch.core.roomgrid import RoomGridState
from minigrid_tpu_torch.core.state import EnvState, new_state
from minigrid_tpu_torch.core.step import success_reward
from minigrid_tpu_torch.envs.gotoobject import permutation_prefix
from minigrid_tpu_torch.envs.unlock import RoomGridEnvBase
from minigrid_tpu_torch.ops import fused_ext as fx

# The reference's colors (obstructedmaze.py:116-122): the target ball is
# COLOR_NAMES[0] (blue), the blocking balls COLOR_NAMES[1] (green), the
# boxes COLOR_NAMES[2] (grey).
_MISSION = mission_vec(template_id("pick up the {0} ball", ("color",)), COLOR_BLUE)
TARGET_BALL = cell(OBJ_BALL, COLOR_BLUE)
_BLOCKING_BALL = cell(OBJ_BALL, COLOR_GREEN)
_BOX = cell(OBJ_BOX, COLOR_GREY)
_DIRS = ((1, 0), (0, 1), (-1, 0), (0, -1))


class ObstructedMazeFusedExt(fx.CachedExt):
    """The family's step overlay (``csrc/ext/obstructed_maze.cuh``; JAX:
    ``minigrid_tpu/envs/obstructedmaze.py::_ObstructedMazeFusedExt``): a
    pickup that leaves the agent carrying the blue ball succeeds.  No extra
    state: the levels, their boxed keys in the contents plane included, come
    from the reset cache."""

    kernel_id = 9
    # Objects (keys in boxes), a per-episode mission, occluding walls.
    kernel_switches = (False, False, False)

    def post_step(self, env, prev, state, action, reward, scal):
        success = (action == Actions.pickup) & ((state.carrying & 0xFFFF) == TARGET_BALL)
        return success, torch.where(success, success_reward(state.step_count, state.max_steps), reward), scal


class ObstructedMazeEnv(RoomGridEnvBase):
    """Locked doors with keys, maybe boxed, and blocking balls; picking up
    the blue ball succeeds (reference: minigrid/envs/obstructedmaze.py:126-167)."""

    fused_ext = ObstructedMazeFusedExt()

    def __init__(self, num_rows: int, num_cols: int, num_rooms_visited: int, max_steps: int | None = None, **kwargs):
        room_size = 6
        if max_steps is None:
            max_steps = 4 * num_rooms_visited * room_size**2
        super().__init__(room_size, num_rows, num_cols, max_steps, **kwargs)

    # -- building blocks -------------------------------------------------------
    def _door_colors(self, generator, n: int, device) -> torch.Tensor:
        """int32 [N, 6]: a uniform permutation of the six sorted colors
        (reference :116)."""
        table = torch.tensor(SORTED_COLOR_IDX, dtype=torch.int32, device=device)
        return table[permutation_prefix(generator, n, len(SORTED_COLOR_IDX), len(SORTED_COLOR_IDX), device)]

    def _add_obstructed_door(self, generator, s, boxed, i, j, door_idx, color, locked, key_in_box, blocked, add_key=True):
        """A door on wall ``door_idx`` of room (i, j), a blocking ball inside
        the room in front of it, and, where locked, its key in the room,
        maybe in a box (reference obstructedmaze.py:136-167)."""
        s, color, pos = self.builder.add_door(generator, s, i, j, door_idx, color=color, locked=locked)
        if blocked:
            dx, dy = _DIRS[door_idx]
            s = s.replace(grid=g.set_cell(s.grid, pos[:, 0] - dx, pos[:, 1] - dy, _BLOCKING_BALL))
        if locked and add_key:
            s = self._add_key(generator, s, boxed, i, j, color, key_in_box)
        return s

    def _add_key(self, generator, s: RoomGridState, boxed: list, i, j, color, key_in_box: bool) -> RoomGridState:
        """A key of ``color`` in room (i, j), inside a grey box where
        ``key_in_box``, whose (position, color) then joins ``boxed``
        (reference obstructedmaze_v1.py:87-99)."""
        s, pos = self.builder.place_in_room(generator, s, i, j, _BOX if key_in_box else cell(OBJ_KEY, color))
        if key_in_box:
            boxed.append((pos, color))
        return s

    def _finish(self, s: RoomGridState, boxed: list) -> EnvState:
        """The episodes, with each boxed key in the contents plane."""
        contains = torch.zeros_like(s.grid)
        for pos, color in boxed:
            contains = g.set_cell(contains, pos[:, 0], pos[:, 1], cell(OBJ_KEY, color))
        return new_state(s.grid, s.agent_pos, s.agent_dir, self.max_steps, contains=contains, mission=_MISSION)

    def _post_step(self, prev, state, action, reward):
        return self.fused_ext.apply_post_step(self, prev, state, action, reward)


class ObstructedMaze_1Dlhb(ObstructedMazeEnv):
    """Two rooms, one locked door (reference: obstructedmaze.py:170-196)."""

    def __init__(self, key_in_box: bool = True, blocked: bool = True, **kwargs):
        self.key_in_box = bool(key_in_box)
        self.blocked = bool(blocked)
        super().__init__(num_rows=1, num_cols=2, num_rooms_visited=2, **kwargs)

    def _generate(self, num_envs: int, generator: torch.Generator | None, device) -> EnvState:
        b = self.builder
        s = b.init(generator, num_envs, device)
        colors = self._door_colors(generator, num_envs, device)
        boxed: list = []
        s = self._add_obstructed_door(
            generator, s, boxed, 0, 0, 0, colors[:, 0], True, self.key_in_box, self.blocked
        )
        s, _ = b.place_in_room(generator, s, 1, 0, TARGET_BALL)
        s = b.place_agent(generator, s, 0, 0)
        return self._finish(s, boxed)


class ObstructedMaze_Full(ObstructedMazeEnv):
    """3x3 rooms with locked doors per quarter (reference:
    obstructedmaze.py:199-256); v1 places the keys after the doors and
    blocking balls of each quarter (obstructedmaze_v1.py)."""

    v1 = False

    def __init__(
        self,
        agent_room: tuple[int, int] = (1, 1),
        key_in_box: bool = True,
        blocked: bool = True,
        num_quarters: int = 4,
        num_rooms_visited: int = 25,
        **kwargs,
    ):
        self.agent_room = tuple(agent_room)
        self.key_in_box = bool(key_in_box)
        self.blocked = bool(blocked)
        self.num_quarters = int(num_quarters)
        super().__init__(num_rows=3, num_cols=3, num_rooms_visited=num_rooms_visited, **kwargs)

    def _generate(self, num_envs: int, generator: torch.Generator | None, device) -> EnvState:
        b, n, nq = self.builder, num_envs, self.num_quarters
        s = b.init(generator, n, device)
        colors = self._door_colors(generator, n, device)
        boxed: list = []
        side_rooms = ((2, 1), (1, 2), (0, 1), (1, 0))[:nq]
        for i, side in enumerate(side_rooms):
            # An open door from the middle room to the side room (reference :234-237).
            s, _, _ = b.add_door(generator, s, 1, 1, i, color=colors[:, i], locked=False)
            deferred = []
            for k in (-1, 1):
                color = colors[:, (i + k) % 6]
                s = self._add_obstructed_door(
                    generator, s, boxed, side[0], side[1], (i + k) % 4, color, True, self.key_in_box, self.blocked,
                    add_key=not self.v1,
                )
                deferred.append(color)
            if self.v1:
                # The quarter's keys after its doors and blocking balls
                # (obstructedmaze_v1.py:61-67).
                for color in deferred:
                    s = self._add_key(generator, s, boxed, side[0], side[1], color, self.key_in_box)
        corners = ((2, 0), (2, 2), (0, 2), (0, 0))[:nq]
        corner = s_.randint(generator, n, 0, nq, device).long()
        cx = torch.tensor([c[0] for c in corners], dtype=torch.int32, device=device)[corner]
        cy = torch.tensor([c[1] for c in corners], dtype=torch.int32, device=device)[corner]
        s, _ = b.place_in_room(generator, s, cx, cy, TARGET_BALL)
        s = b.place_agent(generator, s, self.agent_room[0], self.agent_room[1])
        return self._finish(s, boxed)


class ObstructedMaze_Full_V1(ObstructedMaze_Full):
    v1 = True
