"""Seed-parity mode: host-side level generation that reproduces the
reference's exact RNG draw order.

Counterpart of ``minigrid_tpu/compat/parity.py``.  This package's
generators (``env._generate``) draw from a ``torch.Generator``, whose draws
cannot coincide with the reference's numpy-PCG64 stream.  This module is the
"host-side reference mode" (SURVEY.md §2c note 4): per-family host
generators that consume a ``numpy.random.Generator`` seeded exactly like
``gymnasium.Env.reset(seed=...)`` and replay the draw *order* of the
corresponding reference ``_gen_grid`` (reference:
minigrid/minigrid_env.py:119-157, per-family files cited below).  The host
code is the JAX package's, line for line; what differs is the seam to the
state, a batch of one on the caller's device.

Same seed ⇒ bit-identical grid/agent pose to the reference; combined with
the golden-verified step semantics this yields bit-exact trajectory parity
under fixed seed (BASELINE.md north star).  Generation runs on host (it is
reset-time only); stepping stays on device.

Usage::

    env, state = parity_reset("MiniGrid-DoorKey-8x8-v0", seed=3, device="cpu")
    state, reward = env.step_env(state, torch.tensor([2]))   # device step

For families with step-time randomness (DynamicObstacles), ``ParityRollout``
additionally mirrors the in-step draws host-side.
"""

from __future__ import annotations

import copy
import math
from typing import Any, Callable

import numpy as np
import torch

from minigrid_tpu_torch.core.constants import (
    COLOR_BLUE,
    COLOR_GREEN,
    COLOR_GREY,
    COLOR_RED,
    COLOR_TO_IDX,
    COLOR_YELLOW,
    OBJ_BALL,
    OBJ_BOX,
    OBJ_DOOR,
    OBJ_EMPTY,
    OBJ_GOAL,
    OBJ_KEY,
    OBJ_LAVA,
    OBJ_WALL,
    SORTED_COLOR_IDX,
    STATE_LOCKED,
)
from minigrid_tpu_torch.core.mission import mission_vec as _mission_tensor
from minigrid_tpu_torch.core.state import new_state, resolve_device, tree_map
from minigrid_tpu_torch.core.step import core_step

__all__ = ["parity_reset", "supports_parity", "ParityRollout", "PARITY_GENERATORS"]


def mission_vec(tid: int, *params: int) -> np.ndarray:
    """int32[MISSION_DIM] mission vector on the host (``core/mission``)."""
    return _mission_tensor(tid, *params).numpy()


def pcell(obj_type: int, color: int = 0, state: int = 0) -> int:
    """Pack (type, color, state) into one int — host twin of constants.cell."""
    return int(obj_type) | (int(color) << 8) | (int(state) << 16)


P_EMPTY = pcell(OBJ_EMPTY)
P_WALL = pcell(OBJ_WALL, COLOR_GREY)
P_GOAL = pcell(OBJ_GOAL, COLOR_GREEN)
P_LAVA = pcell(OBJ_LAVA, COLOR_RED)


class HostBuilder:
    """Host-side grid builder mirroring the reference's RNG-consuming helpers.

    Reproduces the draw order of ``MiniGridEnv._rand_*`` / ``place_obj`` /
    ``place_agent`` (reference: minigrid/minigrid_env.py:247-395) over a
    packed int32 numpy grid.  ``self.rng`` is the same
    ``numpy.random.Generator`` gymnasium seeds in ``reset(seed=)``.
    """

    def __init__(self, width: int, height: int, rng: np.random.Generator):
        self.width = width
        self.height = height
        self.rng = rng
        self.grid = np.full((width, height), P_EMPTY, dtype=np.int32)
        self.contains = np.zeros((width, height), dtype=np.int32)
        self.agent_pos: tuple[int, int] = (-1, -1)
        self.agent_dir: int = -1

    # -- grid writes (no RNG) ------------------------------------------------
    def set(self, i: int, j: int, packed: int | None) -> None:
        self.grid[i, j] = P_EMPTY if packed is None else packed

    def get(self, i: int, j: int) -> int:
        return int(self.grid[i, j])

    def is_empty(self, i: int, j: int) -> bool:
        return self.grid[i, j] == P_EMPTY

    def horz_wall(self, x: int, y: int, length: int | None = None, cell: int = P_WALL):
        if length is None:
            length = self.width - x
        self.grid[x : x + length, y] = cell

    def vert_wall(self, x: int, y: int, length: int | None = None, cell: int = P_WALL):
        if length is None:
            length = self.height - y
        self.grid[x, y : y + length] = cell

    def wall_rect(self, x: int, y: int, w: int, h: int):
        self.horz_wall(x, y, w)
        self.horz_wall(x, y + h - 1, w)
        self.vert_wall(x, y, h)
        self.vert_wall(x + w - 1, y, h)

    # -- RNG helpers (one draw per reference draw) ---------------------------
    def rand_int(self, low: int, high: int) -> int:
        return int(self.rng.integers(low, high))

    def rand_bool(self) -> bool:
        return bool(self.rng.integers(0, 2) == 0)

    def rand_elem(self, seq):
        lst = list(seq)
        return lst[self.rand_int(0, len(lst))]

    def rand_color(self) -> int:
        """Color *index* drawn in the reference's sorted-name order
        (reference: minigrid/core/constants.py:17, minigrid_env.py:294-299)."""
        return int(SORTED_COLOR_IDX[self.rand_int(0, 6)])

    def rand_subset(self, seq, num_elems: int) -> list:
        lst = list(seq)
        out = []
        while len(out) < num_elems:
            elem = self.rand_elem(lst)
            lst.remove(elem)
            out.append(elem)
        return out

    def place_obj(
        self,
        packed: int | None,
        top: tuple[int, int] | None = None,
        size: tuple[int, int] | None = None,
        reject_fn: Callable[["HostBuilder", tuple[int, int]], bool] | None = None,
        max_tries: float = math.inf,
    ) -> tuple[int, int]:
        """Rejection-sample an empty cell exactly like the reference
        (minigrid/minigrid_env.py:313-371): same draw per try, same
        accept/reject tests, same exception on exhaustion."""
        if top is None:
            top = (0, 0)
        else:
            top = (max(top[0], 0), max(top[1], 0))
        if size is None:
            size = (self.width, self.height)

        num_tries = 0
        while True:
            if num_tries > max_tries:
                raise RecursionError("rejection sampling failed in place_obj")
            num_tries += 1
            pos = (
                self.rand_int(top[0], min(top[0] + size[0], self.width)),
                self.rand_int(top[1], min(top[1] + size[1], self.height)),
            )
            if not self.is_empty(*pos):
                continue
            if pos == tuple(self.agent_pos):
                continue
            if reject_fn and reject_fn(self, pos):
                continue
            break

        if packed is not None:
            self.grid[pos[0], pos[1]] = packed
        return pos

    def place_agent(
        self,
        top=None,
        size=None,
        rand_dir: bool = True,
        max_tries: float = math.inf,
    ) -> tuple[int, int]:
        self.agent_pos = (-1, -1)
        pos = self.place_obj(None, top, size, max_tries=max_tries)
        self.agent_pos = pos
        if rand_dir:
            self.agent_dir = self.rand_int(0, 4)
        return pos


# ---------------------------------------------------------------------------
# Per-family generators.  Each mirrors the reference `_gen_grid` draw order
# line by line; registered by env class below.
# ---------------------------------------------------------------------------


def _gen_empty(env, b: HostBuilder):
    # reference: minigrid/envs/empty.py:96-114
    b.wall_rect(0, 0, b.width, b.height)
    b.set(b.width - 2, b.height - 2, P_GOAL)
    if env.agent_start_pos is not None:
        b.agent_pos = tuple(env.agent_start_pos)
        b.agent_dir = env.agent_start_dir
    else:
        b.place_agent()


def _gen_distshift(env, b: HostBuilder):
    # reference: minigrid/envs/distshift.py:77,99-121 (no RNG draws at all);
    # goal sits at (width-2, 1), not the usual bottom-right corner.
    b.wall_rect(0, 0, b.width, b.height)
    b.set(b.width - 2, 1, P_GOAL)
    for i in range(b.width - 6):
        b.set(3 + i, 1, P_LAVA)
        b.set(3 + i, env.strip2_row, P_LAVA)
    b.agent_pos = tuple(env.agent_start_pos)
    b.agent_dir = env.agent_start_dir


def _gen_lavagap(env, b: HostBuilder):
    # reference: minigrid/envs/lavagap.py:101-136
    b.wall_rect(0, 0, b.width, b.height)
    b.agent_pos = (1, 1)
    b.agent_dir = 0
    b.set(b.width - 2, b.height - 2, P_GOAL)
    gap_x = b.rand_int(2, b.width - 2)
    gap_y = b.rand_int(1, b.height - 1)
    obstacle = P_LAVA if env.obstacle_type == "lava" else P_WALL
    b.vert_wall(gap_x, 1, b.height - 2, obstacle)
    b.set(gap_x, gap_y, None)


def _gen_crossing(env, b: HostBuilder):
    # reference: minigrid/envs/crossing.py:122-184
    import itertools as itt

    w, h = b.width, b.height
    b.wall_rect(0, 0, w, h)
    b.agent_pos = (1, 1)
    b.agent_dir = 0
    b.set(w - 2, h - 2, P_GOAL)

    v, hz = object(), object()
    rivers = [(v, i) for i in range(2, h - 2, 2)]
    rivers += [(hz, j) for j in range(2, w - 2, 2)]
    b.rng.shuffle(rivers)
    rivers = rivers[: env.num_crossings]
    rivers_v = sorted(pos for direction, pos in rivers if direction is v)
    rivers_h = sorted(pos for direction, pos in rivers if direction is hz)
    obstacle = P_LAVA if env.obstacle_type == "lava" else P_WALL
    obstacle_pos = itt.chain(
        itt.product(range(1, w - 1), rivers_h),
        itt.product(rivers_v, range(1, h - 1)),
    )
    for i, j in obstacle_pos:
        b.set(i, j, obstacle)

    path = [hz] * len(rivers_v) + [v] * len(rivers_h)
    b.rng.shuffle(path)

    limits_v = [0] + rivers_v + [h - 1]
    limits_h = [0] + rivers_h + [w - 1]
    room_i, room_j = 0, 0
    for direction in path:
        if direction is hz:
            i = limits_v[room_i + 1]
            j = int(b.rng.choice(range(limits_h[room_j] + 1, limits_h[room_j + 1])))
            room_i += 1
        else:
            i = int(b.rng.choice(range(limits_v[room_i] + 1, limits_v[room_i + 1])))
            j = limits_h[room_j + 1]
            room_j += 1
        b.set(i, j, None)


def _gen_doorkey(env, b: HostBuilder):
    # reference: minigrid/envs/doorkey.py:75-100
    w, h = b.width, b.height
    b.wall_rect(0, 0, w, h)
    b.set(w - 2, h - 2, P_GOAL)
    split_idx = b.rand_int(2, w - 2)
    b.vert_wall(split_idx, 0)
    b.place_agent(size=(split_idx, h))
    door_idx = b.rand_int(1, h - 2)
    b.set(split_idx, door_idx, pcell(OBJ_DOOR, COLOR_YELLOW, STATE_LOCKED))
    b.place_obj(pcell(OBJ_KEY, COLOR_YELLOW), top=(0, 0), size=(split_idx, h))


def _gen_fourrooms(env, b: HostBuilder):
    # reference: minigrid/envs/fourrooms.py:79-127
    w, h = b.width, b.height
    b.horz_wall(0, 0)
    b.horz_wall(0, h - 1)
    b.vert_wall(0, 0)
    b.vert_wall(w - 1, 0)
    room_w, room_h = w // 2, h // 2
    for j in range(2):
        for i in range(2):
            x_l, y_t = i * room_w, j * room_h
            x_r, y_b = x_l + room_w, y_t + room_h
            if i + 1 < 2:
                b.vert_wall(x_r, y_t, room_h)
                b.set(x_r, b.rand_int(y_t + 1, y_b), None)
            if j + 1 < 2:
                b.horz_wall(x_l, y_b, room_w)
                b.set(b.rand_int(x_l + 1, x_r), y_b, None)
    if env._agent_default_pos is not None:
        b.agent_pos = tuple(env._agent_default_pos)
        b.set(*env._agent_default_pos, None)
        b.agent_dir = b.rand_int(0, 4)
    else:
        b.place_agent()
    if env._goal_default_pos is not None:
        b.set(env._goal_default_pos[0], env._goal_default_pos[1], P_GOAL)
    else:
        b.place_obj(P_GOAL)


def _gen_dynamicobstacles(env, b: HostBuilder):
    # reference: minigrid/envs/dynamicobstacles.py:111-134
    b.wall_rect(0, 0, b.width, b.height)
    b.set(b.width - 2, b.height - 2, P_GOAL)
    if env.agent_start_pos is not None:
        b.agent_pos = tuple(env.agent_start_pos)
        b.agent_dir = env.agent_start_dir
    else:
        b.place_agent()
    obstacles = []
    for _ in range(env.n_obstacles):
        pos = b.place_obj(pcell(OBJ_BALL, COLOR_BLUE), max_tries=100)
        obstacles.append(pos)
    return {
        "extra": {"obstacles": np.asarray(obstacles, dtype=np.int32).reshape(-1, 2)}
    }


_COLOR_NAMES = sorted(COLOR_TO_IDX.keys())
_TYPE_BY_NAME = {"key": OBJ_KEY, "ball": OBJ_BALL, "box": OBJ_BOX}


def _gen_gotodoor(env, b: HostBuilder):
    # reference: minigrid/envs/gotodoor.py:91-131
    from minigrid_tpu_torch.envs.gotodoor import _MISSION

    rw = b.rand_int(5, b.width + 1)
    rh = b.rand_int(5, b.height + 1)
    b.wall_rect(0, 0, rw, rh)

    door_pos = [
        (b.rand_int(2, rw - 2), 0),
        (b.rand_int(2, rw - 2), rh - 1),
        (0, b.rand_int(2, rh - 2)),
        (rw - 1, b.rand_int(2, rh - 2)),
    ]
    door_colors: list[str] = []
    while len(door_colors) < len(door_pos):
        color = b.rand_elem(_COLOR_NAMES)
        if color in door_colors:
            continue
        door_colors.append(color)
    for pos, color in zip(door_pos, door_colors):
        b.set(pos[0], pos[1], pcell(OBJ_DOOR, COLOR_TO_IDX[color], 1))

    b.place_agent(size=(rw, rh))
    door_idx = b.rand_int(0, len(door_pos))
    t_color = COLOR_TO_IDX[door_colors[door_idx]]
    return {
        "extra": {"target_pos": np.asarray(door_pos[door_idx], np.int32)},
        "mission": mission_vec(_MISSION, t_color),
    }


def _gen_fetch(env, b: HostBuilder):
    # reference: minigrid/envs/fetch.py:108-161
    from minigrid_tpu_torch.envs.fetch import _MISSIONS

    b.horz_wall(0, 0)
    b.horz_wall(0, b.height - 1)
    b.vert_wall(0, 0)
    b.vert_wall(b.width - 1, 0)

    objs = []
    while len(objs) < env.num_objs:
        obj_type = b.rand_elem(["key", "ball"])
        obj_color = b.rand_elem(_COLOR_NAMES)
        t, c = _TYPE_BY_NAME[obj_type], COLOR_TO_IDX[obj_color]
        b.place_obj(pcell(t, c))
        objs.append((t, c))
    b.place_agent()

    t_type, t_color = objs[b.rand_int(0, len(objs))]
    syntax = b.rand_int(0, 5)
    return {
        "extra": {"target_type": t_type, "target_color": t_color},
        "mission": mission_vec(_MISSIONS[syntax], t_color, t_type),
    }


def _gen_gotoobject(env, b: HostBuilder):
    # reference: minigrid/envs/gotoobject.py:94-141
    from minigrid_tpu_torch.envs.gotoobject import _MISSION

    b.wall_rect(0, 0, b.width, b.height)
    objs, obj_pos = [], []
    while len(objs) < env.num_objs:
        obj_type = b.rand_elem(["key", "ball", "box"])
        obj_color = b.rand_elem(_COLOR_NAMES)
        if (obj_type, obj_color) in objs:
            continue
        pos = b.place_obj(pcell(_TYPE_BY_NAME[obj_type], COLOR_TO_IDX[obj_color]))
        objs.append((obj_type, obj_color))
        obj_pos.append(pos)
    b.place_agent()

    idx = b.rand_int(0, len(objs))
    t_type, t_color = _TYPE_BY_NAME[objs[idx][0]], COLOR_TO_IDX[objs[idx][1]]
    return {
        "extra": {"target_pos": np.asarray(obj_pos[idx], np.int32)},
        "mission": mission_vec(_MISSION, t_color, t_type),
    }


def _gen_putnear(env, b: HostBuilder):
    # reference: minigrid/envs/putnear.py:103-174
    from minigrid_tpu_torch.envs.putnear import _MISSION

    b.horz_wall(0, 0)
    b.horz_wall(0, b.height - 1)
    b.vert_wall(0, 0)
    b.vert_wall(b.width - 1, 0)

    objs, obj_pos = [], []

    def near_obj(_b, p1):
        for p2 in obj_pos:
            if abs(p1[0] - p2[0]) <= 1 and abs(p1[1] - p2[1]) <= 1:
                return True
        return False

    while len(objs) < env.num_objs:
        obj_type = b.rand_elem(["key", "ball", "box"])
        obj_color = b.rand_elem(_COLOR_NAMES)
        if (obj_type, obj_color) in objs:
            continue
        pos = b.place_obj(
            pcell(_TYPE_BY_NAME[obj_type], COLOR_TO_IDX[obj_color]), reject_fn=near_obj
        )
        objs.append((obj_type, obj_color))
        obj_pos.append(pos)
    b.place_agent()

    move_idx = b.rand_int(0, len(objs))
    while True:
        target_idx = b.rand_int(0, len(objs))
        if target_idx != move_idx:
            break
    m_type, m_color = _TYPE_BY_NAME[objs[move_idx][0]], COLOR_TO_IDX[objs[move_idx][1]]
    t_type, t_color = (
        _TYPE_BY_NAME[objs[target_idx][0]],
        COLOR_TO_IDX[objs[target_idx][1]],
    )
    return {
        "extra": {
            "move_type": m_type,
            "move_color": m_color,
            "target_pos": np.asarray(obj_pos[target_idx], np.int32),
        },
        "mission": mission_vec(_MISSION, m_color, m_type, t_color, t_type),
    }


def _gen_redbluedoors(env, b: HostBuilder):
    # reference: minigrid/envs/redbluedoors.py:81-104 (grid is 2s x s)
    s = env.size
    b.wall_rect(0, 0, 2 * s, s)
    b.wall_rect(s // 2, 0, s, s)
    b.place_agent(top=(s // 2, 0), size=(s, s))
    red_y = b.rand_int(1, s - 1)
    b.set(s // 2, red_y, pcell(OBJ_DOOR, COLOR_RED, 1))
    blue_y = b.rand_int(1, s - 1)
    b.set(s // 2 + s - 1, blue_y, pcell(OBJ_DOOR, COLOR_BLUE, 1))
    return {
        "extra": {
            "red_pos": np.asarray((s // 2, red_y), np.int32),
            "blue_pos": np.asarray((s // 2 + s - 1, blue_y), np.int32),
        }
    }


def _gen_memory(env, b: HostBuilder):
    # reference: minigrid/envs/memory.py:94-151
    w, h = b.width, b.height
    b.horz_wall(0, 0)
    b.horz_wall(0, h - 1)
    b.vert_wall(0, 0)
    b.vert_wall(w - 1, 0)

    upper = h // 2 - 2
    lower = h // 2 + 2
    hallway_end = b.rand_int(4, w - 2) if env.random_length else w - 3

    for i in range(1, 5):
        b.set(i, upper, P_WALL)
        b.set(i, lower, P_WALL)
    b.set(4, upper + 1, P_WALL)
    b.set(4, lower - 1, P_WALL)
    for i in range(5, hallway_end):
        b.set(i, upper + 1, P_WALL)
        b.set(i, lower - 1, P_WALL)
    for j in range(h):
        if j != h // 2:
            b.set(hallway_end, j, P_WALL)
        b.set(hallway_end + 2, j, P_WALL)

    b.agent_pos = (b.rand_int(1, hallway_end + 1), h // 2)
    b.agent_dir = 0

    start_obj = b.rand_elem([OBJ_KEY, OBJ_BALL])
    b.set(1, h // 2 - 1, pcell(start_obj, COLOR_GREEN))
    other_objs = b.rand_elem([[OBJ_BALL, OBJ_KEY], [OBJ_KEY, OBJ_BALL]])
    pos0 = (hallway_end + 1, h // 2 - 2)
    pos1 = (hallway_end + 1, h // 2 + 2)
    b.set(pos0[0], pos0[1], pcell(other_objs[0], COLOR_GREEN))
    b.set(pos1[0], pos1[1], pcell(other_objs[1], COLOR_GREEN))

    if start_obj == other_objs[0]:
        success = (pos0[0], pos0[1] + 1)
        failure = (pos1[0], pos1[1] - 1)
    else:
        success = (pos1[0], pos1[1] - 1)
        failure = (pos0[0], pos0[1] + 1)
    return {
        "extra": {
            "success_pos": np.asarray(success, np.int32),
            "failure_pos": np.asarray(failure, np.int32),
        }
    }


def _gen_playground(env, b: HostBuilder):
    # reference: minigrid/envs/playground.py:31-90
    w, h = b.width, b.height
    b.horz_wall(0, 0)
    b.horz_wall(0, h - 1)
    b.vert_wall(0, 0)
    b.vert_wall(w - 1, 0)
    room_w, room_h = w // 3, h // 3
    for j in range(3):
        for i in range(3):
            x_l, y_t = i * room_w, j * room_h
            x_r, y_b = x_l + room_w, y_t + room_h
            if i + 1 < 3:
                b.vert_wall(x_r, y_t, room_h)
                pos = (x_r, b.rand_int(y_t + 1, y_b - 1))
                b.set(pos[0], pos[1], pcell(OBJ_DOOR, b.rand_color(), 1))
            if j + 1 < 3:
                b.horz_wall(x_l, y_b, room_w)
                pos = (b.rand_int(x_l + 1, x_r - 1), y_b)
                b.set(pos[0], pos[1], pcell(OBJ_DOOR, b.rand_color(), 1))
    b.place_agent()
    for _ in range(12):
        obj_type = b.rand_elem(["key", "ball", "box"])
        obj_color = b.rand_elem(_COLOR_NAMES)
        b.place_obj(pcell(_TYPE_BY_NAME[obj_type], COLOR_TO_IDX[obj_color]))


def _gen_lockedroom(env, b: HostBuilder):
    # reference: minigrid/envs/lockedroom.py:103-174; LockedRoom.rand_pos
    # draws a raw uniform interior position (:18-22).
    from minigrid_tpu_torch.envs.lockedroom import _MISSION

    w, h = b.width, b.height
    b.wall_rect(0, 0, w, h)
    l_wall, r_wall = w // 2 - 2, w // 2 + 2
    b.vert_wall(l_wall, 0)
    b.vert_wall(r_wall, 0)

    rooms = []  # (top, size, door_pos)
    room_w, room_h = l_wall + 1, h // 3 + 1
    for n in range(3):
        j = n * (h // 3)
        b.horz_wall(0, j, l_wall)
        b.horz_wall(r_wall, j, w - r_wall)
        rooms.append(((0, j), (room_w, room_h), (l_wall, j + 3)))
        rooms.append(((r_wall, j), (room_w, room_h), (r_wall, j + 3)))

    def rand_pos(top, size):
        x = b.rand_int(top[0] + 1, top[0] + size[0] - 1)
        y = b.rand_int(top[1] + 1, top[1] + size[1] - 1)
        return (x, y)

    locked = b.rand_elem(rooms)
    locked_idx = rooms.index(locked)
    goal = rand_pos(locked[0], locked[1])
    b.set(goal[0], goal[1], P_GOAL)

    colors = set(_COLOR_NAMES)
    room_colors = []
    for i, room in enumerate(rooms):
        color = b.rand_elem(sorted(colors))
        colors.remove(color)
        room_colors.append(COLOR_TO_IDX[color])
        state = STATE_LOCKED if i == locked_idx else 1
        b.set(room[2][0], room[2][1], pcell(OBJ_DOOR, COLOR_TO_IDX[color], state))

    while True:
        key_room = b.rand_elem(rooms)
        if key_room != locked:
            break
    key_idx = rooms.index(key_room)
    key_pos = rand_pos(key_room[0], key_room[1])
    b.set(key_pos[0], key_pos[1], pcell(OBJ_KEY, room_colors[locked_idx]))

    b.place_agent(top=(l_wall, 0), size=(r_wall - l_wall, h))
    lc, kc = room_colors[locked_idx], room_colors[key_idx]
    return {"mission": mission_vec(_MISSION, lc, kc, lc)}


def _gen_multiroom(env, b: HostBuilder):
    # reference: minigrid/envs/multiroom.py:112-279 (recursive room chain)
    w, h = b.width, b.height
    num_rooms = b.rand_int(env.min_rooms, env.max_rooms + 1)

    def place_room(num_left, room_list, min_sz, max_sz, entry_wall, entry_pos):
        size_x = b.rand_int(min_sz, max_sz + 1)
        size_y = b.rand_int(min_sz, max_sz + 1)
        if len(room_list) == 0:
            top_x, top_y = entry_pos
        elif entry_wall == 0:
            top_x = entry_pos[0] - size_x + 1
            top_y = b.rand_int(entry_pos[1] - size_y + 2, entry_pos[1])
        elif entry_wall == 1:
            top_x = b.rand_int(entry_pos[0] - size_x + 2, entry_pos[0])
            top_y = entry_pos[1] - size_y + 1
        elif entry_wall == 2:
            top_x = entry_pos[0]
            top_y = b.rand_int(entry_pos[1] - size_y + 2, entry_pos[1])
        else:
            top_x = b.rand_int(entry_pos[0] - size_x + 2, entry_pos[0])
            top_y = entry_pos[1]

        if top_x < 0 or top_y < 0:
            return False
        if top_x + size_x > w or top_y + size_y >= h:
            return False
        for room in room_list[:-1]:
            non_overlap = (
                top_x + size_x < room[0][0]
                or room[0][0] + room[1][0] <= top_x
                or top_y + size_y < room[0][1]
                or room[0][1] + room[1][1] <= top_y
            )
            if not non_overlap:
                return False

        room_list.append(((top_x, top_y), (size_x, size_y), entry_pos))
        if num_left == 1:
            return True
        for _ in range(8):
            wall_set = {0, 1, 2, 3}
            wall_set.remove(entry_wall)
            exit_wall = b.rand_elem(sorted(wall_set))
            next_entry_wall = (exit_wall + 2) % 4
            if exit_wall == 0:
                exit_pos = (top_x + size_x - 1, top_y + b.rand_int(1, size_y - 1))
            elif exit_wall == 1:
                exit_pos = (top_x + b.rand_int(1, size_x - 1), top_y + size_y - 1)
            elif exit_wall == 2:
                exit_pos = (top_x, top_y + b.rand_int(1, size_y - 1))
            else:
                exit_pos = (top_x + b.rand_int(1, size_x - 1), top_y)
            if place_room(
                num_left - 1, room_list, min_sz, max_sz, next_entry_wall, exit_pos
            ):
                break
        return True

    room_list: list = []
    while len(room_list) < num_rooms:
        cur: list = []
        # NOTE: the reference draws BOTH entry coordinates from the width
        # range (minigrid/envs/multiroom.py:121) — mirrored as-is.
        entry_pos = (b.rand_int(0, w - 2), b.rand_int(0, w - 2))
        place_room(num_rooms, cur, 4, env.max_room_size, 2, entry_pos)
        if len(cur) > len(room_list):
            room_list = cur

    prev_door_color = None
    for idx, (top, size, entry_pos) in enumerate(room_list):
        for i in range(size[0]):
            b.set(top[0] + i, top[1], P_WALL)
            b.set(top[0] + i, top[1] + size[1] - 1, P_WALL)
        for j in range(size[1]):
            b.set(top[0], top[1] + j, P_WALL)
            b.set(top[0] + size[0] - 1, top[1] + j, P_WALL)
        if idx > 0:
            door_colors = set(_COLOR_NAMES)
            if prev_door_color:
                door_colors.remove(prev_door_color)
            door_color = b.rand_elem(sorted(door_colors))
            b.set(entry_pos[0], entry_pos[1], pcell(OBJ_DOOR, COLOR_TO_IDX[door_color], 1))
            prev_door_color = door_color

    b.place_agent(room_list[0][0], room_list[0][1])
    b.place_obj(P_GOAL, room_list[-1][0], room_list[-1][1])


class HostRoomGrid(HostBuilder):
    """Host twin of the reference ``RoomGrid`` base
    (reference: minigrid/core/roomgrid.py:66-438): lattice walls, per-wall
    door slots (drawn in ``_gen_grid``'s row-major order :147-171), doors,
    wall removal, in-room placement with the next-to-agent rejection, the
    agent placement retry loop, ``connect_all`` and ``add_distractors`` —
    all consuming the given numpy Generator draw for draw."""

    _NEIGHBOR = [(1, 0), (0, 1), (-1, 0), (0, -1)]  # right, down, left, up

    def __init__(self, room_size: int, num_rows: int, num_cols: int, rng):
        width = (room_size - 1) * num_cols + 1
        height = (room_size - 1) * num_rows + 1
        super().__init__(width, height, rng)
        self.room_size = room_size
        self.num_rows = num_rows
        self.num_cols = num_cols
        self.room_door_pos: dict = {}
        self.room_doors: dict = {}
        self.room_locked: dict = {}
        self.room_objs: dict = {}

        for j in range(num_rows):
            for i in range(num_cols):
                self.wall_rect(
                    i * (room_size - 1), j * (room_size - 1), room_size, room_size
                )
                self.room_door_pos[(i, j)] = [None] * 4
                self.room_doors[(i, j)] = [None] * 4
                self.room_locked[(i, j)] = False
                self.room_objs[(i, j)] = []

        for j in range(num_rows):
            for i in range(num_cols):
                top_x, top_y = i * (room_size - 1), j * (room_size - 1)
                x_l, y_l = top_x + 1, top_y + 1
                x_m, y_m = top_x + room_size - 1, top_y + room_size - 1
                dp = self.room_door_pos[(i, j)]
                if i < num_cols - 1:
                    dp[0] = (x_m, self.rand_int(y_l, y_m))
                if j < num_rows - 1:
                    dp[1] = (self.rand_int(x_l, x_m), y_m)
                if i > 0:
                    dp[2] = self.room_door_pos[(i - 1, j)][0]
                if j > 0:
                    dp[3] = self.room_door_pos[(i, j - 1)][1]

        self.agent_pos = (
            (num_cols // 2) * (room_size - 1) + room_size // 2,
            (num_rows // 2) * (room_size - 1) + room_size // 2,
        )
        self.agent_dir = 0

    def neighbor(self, i: int, j: int, k: int):
        di, dj = self._NEIGHBOR[k]
        ni, nj = i + di, j + dj
        if 0 <= ni < self.num_cols and 0 <= nj < self.num_rows:
            return (ni, nj)
        return None

    def room_top(self, i: int, j: int) -> tuple[int, int]:
        return (i * (self.room_size - 1), j * (self.room_size - 1))

    def add_door(self, i, j, door_idx=None, color=None, locked=None):
        """reference: minigrid/core/roomgrid.py:230-273; returns
        (color_name, pos)."""
        if door_idx is None:
            while True:
                door_idx = self.rand_int(0, 4)
                if (
                    self.neighbor(i, j, door_idx)
                    and self.room_doors[(i, j)][door_idx] is None
                ):
                    break
        if color is None:
            color = self.rand_elem(_COLOR_NAMES)
        if locked is None:
            locked = self.rand_bool()

        assert self.room_doors[(i, j)][door_idx] is None, "door already exists"
        self.room_locked[(i, j)] = locked
        pos = self.room_door_pos[(i, j)][door_idx]
        state = STATE_LOCKED if locked else 1
        self.set(pos[0], pos[1], pcell(OBJ_DOOR, COLOR_TO_IDX[color], state))
        # One shared dict per door (the reference shares one Door object
        # between the two adjacent rooms).
        door = {"color": color, "locked": locked, "pos": pos}
        self.room_doors[(i, j)][door_idx] = door
        n = self.neighbor(i, j, door_idx)
        self.room_doors[n][(door_idx + 2) % 4] = door
        return color, pos

    def remove_wall(self, i, j, wall_idx):
        """reference: minigrid/core/roomgrid.py:276-311."""
        tx, ty = self.room_top(i, j)
        w = h = self.room_size
        if wall_idx == 0:
            for t in range(1, h - 1):
                self.set(tx + w - 1, ty + t, None)
        elif wall_idx == 1:
            for t in range(1, w - 1):
                self.set(tx + t, ty + h - 1, None)
        elif wall_idx == 2:
            for t in range(1, h - 1):
                self.set(tx, ty + t, None)
        else:
            for t in range(1, w - 1):
                self.set(tx + t, ty, None)
        self.room_doors[(i, j)][wall_idx] = True
        n = self.neighbor(i, j, wall_idx)
        self.room_doors[n][(wall_idx + 2) % 4] = True

    def _reject_next_to(self, _b, pos):
        sx, sy = self.agent_pos
        return abs(sx - pos[0]) + abs(sy - pos[1]) < 2

    def place_in_room(self, i, j, packed, obj_key=None, contains=None):
        """reference: minigrid/core/roomgrid.py:183-197."""
        pos = self.place_obj(
            packed,
            self.room_top(i, j),
            (self.room_size, self.room_size),
            reject_fn=self._reject_next_to,
            max_tries=1000,
        )
        if contains is not None:
            self.contains[pos[0], pos[1]] = contains
        self.room_objs[(i, j)].append(obj_key)
        return pos

    def add_object(self, i, j, kind=None, color=None):
        """reference: minigrid/core/roomgrid.py:199-227; returns
        (kind, color_name, pos)."""
        if kind is None:
            kind = self.rand_elem(["key", "ball", "box"])
        if color is None:
            color = self.rand_elem(_COLOR_NAMES)
        pos = self.place_in_room(
            i, j, pcell(_TYPE_BY_NAME[kind], COLOR_TO_IDX[color]), (kind, color)
        )
        return kind, color, pos

    def place_agent_room(self, i=None, j=None, rand_dir=True):
        """reference: minigrid/core/roomgrid.py:313-334 — re-place until the
        front cell is empty or a wall."""
        if i is None:
            i = self.rand_int(0, self.num_cols)
        if j is None:
            j = self.rand_int(0, self.num_rows)
        top = self.room_top(i, j)
        size = (self.room_size, self.room_size)
        while True:
            self.place_agent(top, size, rand_dir, max_tries=1000)
            dx, dy = [(1, 0), (0, 1), (-1, 0), (0, -1)][self.agent_dir]
            fx, fy = self.agent_pos[0] + dx, self.agent_pos[1] + dy
            front = self.grid[fx, fy]
            if front == P_EMPTY or (front & 0xFF) == OBJ_WALL:
                break
        return self.agent_pos

    def connect_all(self, door_colors=None, max_itrs: int = 5000):
        """reference: minigrid/core/roomgrid.py:336-394."""
        if door_colors is None:
            door_colors = _COLOR_NAMES
        start = (
            self.agent_pos[0] // (self.room_size - 1),
            self.agent_pos[1] // (self.room_size - 1),
        )

        def find_reach():
            reach = set()
            stack = [start]
            while stack:
                room = stack.pop()
                if room in reach:
                    continue
                reach.add(room)
                for k in range(4):
                    if self.room_doors[room][k]:
                        stack.append(self.neighbor(room[0], room[1], k))
            return reach

        num_itrs = 0
        while True:
            if num_itrs > max_itrs:
                raise RecursionError("connect_all failed")
            num_itrs += 1
            if len(find_reach()) == self.num_rows * self.num_cols:
                break
            i = self.rand_int(0, self.num_cols)
            j = self.rand_int(0, self.num_rows)
            k = self.rand_int(0, 4)
            if not self.room_door_pos[(i, j)][k] or self.room_doors[(i, j)][k]:
                continue
            n = self.neighbor(i, j, k)
            if self.room_locked[(i, j)] or self.room_locked[n]:
                continue
            color = self.rand_elem(door_colors)
            self.add_door(i, j, k, color, False)

    def add_distractors(self, i=None, j=None, num_distractors=10, all_unique=True):
        """reference: minigrid/core/roomgrid.py:396-438."""
        objs = []
        for room, items in self.room_objs.items():
            objs.extend(o for o in items if o is not None)
        dists = []
        while len(dists) < num_distractors:
            color = self.rand_elem(_COLOR_NAMES)
            kind = self.rand_elem(["key", "ball", "box"])
            obj = (kind, color)
            if all_unique and obj in objs:
                continue
            room_i = self.rand_int(0, self.num_cols) if i is None else i
            room_j = self.rand_int(0, self.num_rows) if j is None else j
            _, _, pos = self.add_object(room_i, room_j, *obj)
            objs.append(obj)
            dists.append((kind, color, pos))
        return dists


def _roomgrid_builder(env, b: HostBuilder) -> HostRoomGrid:
    """Fresh HostRoomGrid continuing ``b``'s RNG stream; its result is
    copied back into ``b`` by ``_finish_roomgrid``."""
    eb = env.builder
    return HostRoomGrid(eb.room_size, eb.num_rows, eb.num_cols, b.rng)


def _finish_roomgrid(b: HostBuilder, rg: HostRoomGrid):
    b.grid = rg.grid
    b.contains = rg.contains
    b.agent_pos = rg.agent_pos
    b.agent_dir = rg.agent_dir


def _gen_unlock(env, b: HostBuilder):
    # reference: minigrid/envs/unlock.py:76-87
    rg = _roomgrid_builder(env, b)
    color, door_pos = rg.add_door(0, 0, 0, locked=True)
    rg.add_object(0, 0, "key", color)
    rg.place_agent_room(0, 0)
    _finish_roomgrid(b, rg)
    return {"extra": {"door_pos": np.asarray(door_pos, np.int32)}}


def _gen_unlockpickup(env, b: HostBuilder):
    # reference: minigrid/envs/unlockpickup.py:83-96 and
    # blockedunlockpickup.py:90-106 (blocked adds a ball before the key)
    from minigrid_tpu_torch.envs.unlock import MISSION_PICKUP as _MISSION_PICKUP

    rg = _roomgrid_builder(env, b)
    _, box_color, _ = rg.add_object(1, 0, kind="box")
    door_color, door_pos = rg.add_door(0, 0, 0, locked=True)
    if env.blocked:
        ball_color = rg.rand_color()
        rg.set(door_pos[0] - 1, door_pos[1], pcell(OBJ_BALL, ball_color))
    rg.add_object(0, 0, "key", door_color)
    rg.place_agent_room(0, 0)
    _finish_roomgrid(b, rg)
    c = COLOR_TO_IDX[box_color]
    return {
        "extra": {"target_color": np.int32(c)},
        "mission": mission_vec(_MISSION_PICKUP, c, OBJ_BOX),
    }


def _gen_keycorridor(env, b: HostBuilder):
    # reference: minigrid/envs/keycorridor.py:104-127
    from minigrid_tpu_torch.envs.unlock import MISSION_PICKUP as _MISSION_PICKUP

    rg = _roomgrid_builder(env, b)
    for j in range(1, rg.num_rows):
        rg.remove_wall(1, j, 3)
    room_idx = rg.rand_int(0, rg.num_rows)
    door_color, _ = rg.add_door(2, room_idx, 2, locked=True)
    kind = {OBJ_BALL: "ball", OBJ_KEY: "key"}[env.obj_kind]
    _, obj_color, _ = rg.add_object(2, room_idx, kind=kind)
    rg.add_object(0, rg.rand_int(0, rg.num_rows), "key", door_color)
    rg.place_agent_room(1, rg.num_rows // 2)
    rg.connect_all()
    _finish_roomgrid(b, rg)
    c = COLOR_TO_IDX[obj_color]
    return {
        "extra": {"target_color": np.int32(c)},
        "mission": mission_vec(_MISSION_PICKUP, c, int(env.obj_kind)),
    }


def _obstructed_prelude(env, b: HostBuilder):
    # reference: minigrid/envs/obstructedmaze.py:113-126
    rg = _roomgrid_builder(env, b)
    door_colors = rg.rand_subset(_COLOR_NAMES, len(_COLOR_NAMES))
    return rg, door_colors


def _obstructed_add_door(rg, door_colors, i, j, door_idx, color, locked,
                         key_in_box, blocked, add_key=True):
    # reference: minigrid/envs/obstructedmaze.py:137-165
    door_color, pos = rg.add_door(i, j, door_idx, color, locked=locked)
    if blocked:
        vec = HostRoomGrid._NEIGHBOR[door_idx]
        # blocking_ball_color = COLOR_NAMES[1] = "green"
        rg.set(pos[0] - vec[0], pos[1] - vec[1], pcell(OBJ_BALL, COLOR_TO_IDX["green"]))
    if locked and add_key:
        _obstructed_add_key(rg, i, j, door_color, key_in_box)
    return door_color, pos


def _obstructed_add_key(rg, i, j, color, key_in_box):
    key_packed = pcell(OBJ_KEY, COLOR_TO_IDX[color])
    if key_in_box:
        # box_color = COLOR_NAMES[2] = "grey"; key hidden in the contains plane
        rg.place_in_room(
            i, j, pcell(OBJ_BOX, COLOR_TO_IDX["grey"]), ("box", "grey"),
            contains=key_packed & 0xFFFF,
        )
    else:
        rg.place_in_room(i, j, key_packed, ("key", color))


def _gen_obstructed_1dlhb(env, b: HostBuilder):
    # reference: minigrid/envs/obstructedmaze.py:190-205
    rg, door_colors = _obstructed_prelude(env, b)
    _obstructed_add_door(
        rg, door_colors, 0, 0, 0, door_colors[0], True, env.key_in_box, env.blocked
    )
    rg.add_object(1, 0, "ball", color="blue")  # ball_to_find_color = COLOR_NAMES[0]
    rg.place_agent_room(0, 0)
    _finish_roomgrid(b, rg)


def _gen_obstructed_full(env, b: HostBuilder):
    # reference: minigrid/envs/obstructedmaze.py:231-252
    rg, door_colors = _obstructed_prelude(env, b)
    middle = (1, 1)
    side_rooms = [(2, 1), (1, 2), (0, 1), (1, 0)][: env.num_quarters]
    for i, side in enumerate(side_rooms):
        rg.add_door(middle[0], middle[1], i, door_colors[i], locked=False)
        for k in (-1, 1):
            _obstructed_add_door(
                rg, door_colors, side[0], side[1], (i + k) % 4,
                door_colors[(i + k) % len(door_colors)], True,
                env.key_in_box, env.blocked,
            )
    corners = [(2, 0), (2, 2), (0, 2), (0, 0)][: env.num_quarters]
    ball_room = rg.rand_elem(corners)
    rg.add_object(ball_room[0], ball_room[1], "ball", color="blue")
    rg.place_agent_room(env.agent_room[0], env.agent_room[1])
    _finish_roomgrid(b, rg)


def _gen_obstructed_full_v1(env, b: HostBuilder):
    # reference: minigrid/envs/obstructedmaze_v1.py:37-75 — all doors and
    # blocking balls first, then the keys.
    rg, door_colors = _obstructed_prelude(env, b)
    middle = (1, 1)
    side_rooms = [(2, 1), (1, 2), (0, 1), (1, 0)][: env.num_quarters]
    for i, side in enumerate(side_rooms):
        rg.add_door(middle[0], middle[1], i, door_colors[i], locked=False)
        for k in (-1, 1):
            _obstructed_add_door(
                rg, door_colors, side[0], side[1], (i + k) % 4,
                door_colors[(i + k) % len(door_colors)], True,
                env.key_in_box, env.blocked, add_key=False,
            )
        for k in (-1, 1):
            _obstructed_add_key(
                rg, side[0], side[1],
                door_colors[(i + k) % len(door_colors)], env.key_in_box,
            )
    corners = [(2, 0), (2, 2), (0, 2), (0, 0)][: env.num_quarters]
    ball_room = rg.rand_elem(corners)
    rg.add_object(ball_room[0], ball_room[1], "ball", color="blue")
    rg.place_agent_room(env.agent_room[0], env.agent_room[1])
    _finish_roomgrid(b, rg)


PARITY_GENERATORS: dict[str, Callable[[Any, HostBuilder], Any]] = {
    "EmptyEnv": _gen_empty,
    "DistShiftEnv": _gen_distshift,
    "LavaGapEnv": _gen_lavagap,
    "CrossingEnv": _gen_crossing,
    "DoorKeyEnv": _gen_doorkey,
    "FourRoomsEnv": _gen_fourrooms,
    "DynamicObstaclesEnv": _gen_dynamicobstacles,
    "GoToDoorEnv": _gen_gotodoor,
    "FetchEnv": _gen_fetch,
    "GoToObjectEnv": _gen_gotoobject,
    "PutNearEnv": _gen_putnear,
    "RedBlueDoorEnv": _gen_redbluedoors,
    "MemoryEnv": _gen_memory,
    "PlaygroundEnv": _gen_playground,
    "LockedRoomEnv": _gen_lockedroom,
    "MultiRoomEnv": _gen_multiroom,
    "UnlockEnv": _gen_unlock,
    "UnlockPickupEnv": _gen_unlockpickup,
    "BlockedUnlockPickupEnv": _gen_unlockpickup,
    "KeyCorridorEnv": _gen_keycorridor,
    "ObstructedMaze_1Dlhb": _gen_obstructed_1dlhb,
    "ObstructedMaze_Full": _gen_obstructed_full,
    "ObstructedMaze_Full_V1": _gen_obstructed_full_v1,
}


def _gen_wfc(env, b: HostBuilder):
    # Solver-inclusive WFC parity lives in compat/parity_wfc.py (lazy import:
    # it pulls in the WFC preprocessing tables).
    from minigrid_tpu_torch.compat.parity_wfc import gen_wfc

    return gen_wfc(env, b)


PARITY_GENERATORS["WFCEnv"] = _gen_wfc


def _lookup_generator(env):
    """Resolve a parity generator walking the env's MRO (registry variants
    subclass the family classes).  BabyAI levels dispatch to the shared
    RoomGridLevel parity generator (compat/parity_babyai.py)."""
    for klass in type(env).__mro__:
        gen = PARITY_GENERATORS.get(klass.__name__)
        if gen is not None:
            return gen
    from minigrid_tpu_torch.compat import parity_babyai

    for klass in type(env).__mro__:
        if klass.__name__ in parity_babyai.BABYAI_GEN_MISSION:
            return parity_babyai.babyai_parity_gen
    return None


def supports_parity(env) -> bool:
    return _lookup_generator(env) is not None


def np_random(seed: int | None = None) -> tuple[np.random.Generator, int]:
    """The generator gymnasium's ``Env.reset(seed=)`` installs and its
    entropy: ``gymnasium.utils.seeding.np_random``, kept here so that
    parity mode needs no gymnasium.  ``seed`` None draws fresh
    entropy from the operating system."""
    if seed is not None and not (isinstance(seed, int) and seed >= 0):
        if not isinstance(seed, int):
            raise ValueError(f"Seed must be a python integer, actual type: {type(seed)}")
        raise ValueError(f"Seed must be greater or equal to zero, actual value: {seed}")
    seed_seq = np.random.SeedSequence(seed)
    return np.random.Generator(np.random.PCG64(seed_seq)), seed_seq.entropy


def _np_random(seed: int | None) -> np.random.Generator:
    return np_random(seed)[0]


def _resolve_env(env_or_id):
    if isinstance(env_or_id, str):
        from minigrid_tpu_torch.registry import make

        return make(env_or_id)
    return env_or_id


def parity_reset(env_or_id, seed: int, device=None):
    """Reset in parity mode: build the episode the reference would build for
    ``seed`` and return ``(env, EnvState)`` (a batch of one, on ``device``,
    the card unless the caller asks for the CPU) ready for stepping.

    The state's grid, agent pose, mission and family fields equal the JAX
    package's ``parity_reset`` bit for bit (tests/test_torch_parity*.py),
    which the JAX package holds to the reference
    (tests/test_seed_parity*.py).
    """
    env = _resolve_env(env_or_id)
    return env, generate_with_rng(env, _np_random(seed), seed, device)


def _on(device, value, dtype=torch.int32) -> torch.Tensor:
    """A host value as a batch-of-one tensor on ``device``."""
    return torch.as_tensor(np.asarray(value)[None], dtype=dtype, device=device)


def _template(env, device):
    """The family's default mission and ``extra`` structure: one level of
    its own generator on ``device`` (a generator seeded 0), made once per env
    instance and device, as the JAX package caches ``_generate(PRNGKey(0))``.
    A fresh copy on each call, so that no state shares its tensors."""
    cache = env.__dict__.setdefault("_parity_templates", {})
    key = str(device)
    if key not in cache:
        cache[key] = env._generate(1, torch.Generator(device=device).manual_seed(0), device)
    return cache[key].map(torch.clone)


def _walk_seed(key_seed: int, device) -> torch.Tensor:
    """Dynamic-Obstacles' per-episode walk stream (``extra["walk_seed"]``),
    drawn from the parity seed.  Parity stepping moves the balls on the host
    stream (``ParityRollout``) and never reads it."""
    from minigrid_tpu_torch.envs.dynamicobstacles import _WALK_TAG
    from minigrid_tpu_torch.ops.prng import threefry2x32, to_int32

    k0, k1 = key_seed & 0xFFFFFFFF, (key_seed >> 32) & 0xFFFFFFFF
    w0, w1 = threefry2x32(torch.tensor([k0]), torch.tensor([k1]), *_WALK_TAG)
    return to_int32(torch.stack([w0, w1], dim=-1)).to(device)


def generate_with_rng(env, rng: np.random.Generator, key_seed: int = 0, device=None):
    """Host-generate the next episode by CONTINUING ``rng``'s stream —
    exactly what the reference does on ``reset()`` without a seed (gymnasium
    keeps ``np_random``; generation draws continue from where the previous
    episode left off).  Returns a batch-of-one ``EnvState`` on ``device``
    (the card unless the caller asks for the CPU)."""
    device = resolve_device(None, device)
    gen = _lookup_generator(env)
    if gen is None:
        raise NotImplementedError(
            f"no parity generator for {type(env).__name__}; see PARITY_GENERATORS"
        )

    b = HostBuilder(env.width, env.height, rng)
    out = gen(env, b) or {}
    if not (b.agent_pos >= (0, 0) and b.agent_dir >= 0):
        raise RuntimeError(f"{type(env).__name__}: the parity generator placed no agent")

    if out.get("complete"):
        # The generator supplied every episode-specific field — assemble the
        # state directly, skipping the (possibly expensive) device template.
        state = new_state(
            grid=_on(device, b.grid),
            agent_pos=b.agent_pos,
            agent_dir=b.agent_dir,
            max_steps=out.get("max_steps", env.max_steps),
            contains=_on(device, b.contains),
            mission=_on(device, out["mission"]),
            extra=tree_map(lambda t: t.to(device), out.get("extra")),
        )
        if out.get("carrying"):
            state = state.replace(carrying=_on(device, out["carrying"]))
        return state

    # Template state from the device generator supplies the family's default
    # mission vector and extra structure; all parity-relevant leaves are
    # overwritten from the host build.
    template = _template(env, device)
    extra = template.extra
    if extra is not None and "walk_seed" in extra:
        extra = dict(extra, walk_seed=_walk_seed(key_seed, device))
    if out.get("extra") is not None:
        extra = dict(extra or {})
        for k, v in out["extra"].items():
            dtype = extra[k].dtype if k in extra else None
            extra[k] = _on(device, v, dtype)
    mission = out.get("mission")
    if mission is not None:
        template = template.replace(mission=_on(device, mission))
    if out.get("max_steps") is not None:
        template = template.replace(max_steps=_on(device, out["max_steps"]))
    return template.replace(
        grid=_on(device, b.grid),
        contains=_on(device, b.contains),
        agent_x=_on(device, b.agent_pos[0]),
        agent_y=_on(device, b.agent_pos[1]),
        agent_dir=_on(device, b.agent_dir),
        carrying=_on(device, out.get("carrying", 0)),
        step_count=_on(device, 0),
        terminated=_on(device, False, torch.bool),
        truncated=_on(device, False, torch.bool),
        extra=extra,
    )


def _host_scalars(*values: torch.Tensor) -> list[float]:
    """Batch-of-one tensors (rewards, flags) read back to the host in one
    transfer, as floats in argument order."""
    return torch.cat([v.reshape(-1)[:1].to(torch.float64) for v in values]).tolist()


class ParityRollout:
    """Host-driven episode loop with full in-step RNG parity.

    For most families the ``step_env`` transition is already bit-exact given
    a parity reset; DynamicObstacles additionally draws RNG *during* step
    (the obstacle random walk, reference: minigrid/envs/dynamicobstacles.py:
    144-156) — those draws are mirrored here on the host RNG and the moved
    obstacle layout is written into the state before the core transition
    runs.  The state is a batch of one on ``device`` (the card unless the
    caller asks for the CPU); its observations go through
    ``env.observation``, the observation kernel on the card.
    """

    def __init__(self, env_or_id, seed: int | None = 0, device=None):
        self.env = _resolve_env(env_or_id)
        self.device = resolve_device(None, device)
        self._builder = HostBuilder(self.env.width, self.env.height, None)
        self.rng = None
        self.new_episode(seed)

    def new_episode(self, seed: int | None = None) -> None:
        """The next episode's state, without its observation: a seed
        restarts the host RNG stream, no seed continues it (like the
        reference's np_random)."""
        if seed is not None or self.rng is None:
            self.rng = _np_random(seed)
            self.seed = seed if seed is not None else 0
        self.state = generate_with_rng(self.env, self.rng, self.seed, self.device)
        self._builder.rng = self.rng

    def reset(self, seed: int | None = None):
        """Mirror of ``gymnasium.Env.reset``: ``new_episode`` and its
        observation."""
        self.new_episode(seed)
        return self.observation()

    def observation(self):
        return self.env.observation(self.state)

    def __getstate__(self):
        # The host RNG stream, builder and state round-trip, so an unpickled
        # rollout continues the exact episode (reference conformance:
        # tests/test_envs.py:174-184).  The state travels on the CPU and
        # returns to ``device``; the env's template cache is left behind.
        state = self.__dict__.copy()
        state["env"] = _without_templates(self.env)
        state["state"] = self.state.map(lambda t: t.cpu())
        state["device"] = str(self.device)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.device = torch.device(self.device)
        self.state = self.state.map(lambda t: t.to(self.device))

    def advance(self, action: int):
        """One transition: the family's action map, the core step and its
        post-step overlay, and *not* its pre-step hook, whose draws the host
        mirror replaces.  Returns (state, reward) on the device."""
        state = self.state
        if type(self.env).__name__ == "DynamicObstaclesEnv":
            state = self._move_obstacles_host(state, action)
        a = torch.full((1,), int(action), dtype=torch.int32, device=self.device)
        prev = state
        state, reward = core_step(state, self.env._map_action(a))
        state, reward = self.env._post_step(prev, state, a, reward)
        self.state = state
        return state, reward

    def step(self, action: int):
        """One transition; returns (obs, reward, terminated, truncated)."""
        state, reward = self.advance(action)
        r, term, trunc = _host_scalars(reward, state.terminated, state.truncated)
        return self.env.observation(state), r, bool(term), bool(trunc)

    def _move_obstacles_host(self, state, action):
        """Mirror the reference's obstacle walk draws on the host RNG
        (reference: minigrid/envs/dynamicobstacles.py:136-156)."""
        b = self._builder
        w, h = b.width, b.height
        # One transfer: the grid, the pose and the balls.
        flat = torch.cat(
            [state.grid[0].reshape(-1), state.agent_x, state.agent_y, state.agent_dir,
             state.extra["obstacles"][0].reshape(-1)]
        ).cpu().numpy()
        b.grid = flat[: w * h].reshape(w, h).copy()
        ax, ay, adir = (int(v) for v in flat[w * h : w * h + 3])
        b.agent_pos = (ax, ay)

        # front_not_clear is evaluated BEFORE obstacles move (:141-143).
        dx, dy = [(1, 0), (0, 1), (-1, 0), (0, -1)][adir]
        ft = int(b.grid[ax + dx, ay + dy]) & 0xFF
        not_clear = ft not in (OBJ_EMPTY, OBJ_GOAL)

        obstacles = flat[w * h + 3 :].reshape(-1, 2).copy()
        for i in range(obstacles.shape[0]):
            old = (int(obstacles[i, 0]), int(obstacles[i, 1]))
            try:
                ball = pcell(OBJ_BALL, COLOR_BLUE)
                pos = b.place_obj(
                    ball, top=(old[0] - 1, old[1] - 1), size=(3, 3), max_tries=100
                )
                b.set(old[0], old[1], None)
                obstacles[i] = pos
            except RecursionError:
                pass

        extra = dict(state.extra)
        extra["obstacles"] = _on(self.device, obstacles, state.extra["obstacles"].dtype)
        extra["front_not_clear"] = _on(self.device, not_clear, torch.bool)
        return state.replace(grid=_on(self.device, b.grid), extra=extra)


def _without_templates(env):
    """A shallow copy of ``env`` without its parity template cache (device
    tensors that any later reset makes again)."""
    if "_parity_templates" not in env.__dict__:
        return env
    clone = copy.copy(env)
    del clone.__dict__["_parity_templates"]
    return clone
