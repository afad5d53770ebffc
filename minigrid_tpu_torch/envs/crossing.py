"""Crossing mazes (reference: minigrid/envs/crossing.py:13-184).

N lava or wall "rivers" on even rows and columns, with one opening per
river along a random room-to-room path, so the goal stays reachable.  The
family's generator is its counter-stream ``reset_block`` (the JAX package's
``_CrossingResetExt``, ``minigrid_tpu/envs/crossing.py:152-290``), which
the whole-rollout kernel also runs at every episode end
(``csrc/ext/crossing.cuh``); ``tests/test_counter_reset.py`` ties its level
distribution to the JAX package's ``_generate``.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core.constants import EMPTY_CELL, GOAL_CELL, LAVA_CELL, WALL_CELL
from minigrid_tpu_torch.core.env import MiniGridEnv
from minigrid_tpu_torch.core.mission import mission_vec, template_id
from minigrid_tpu_torch.core.state import EnvState, new_state
from minigrid_tpu_torch.ops import fused_ext as fx
from minigrid_tpu_torch.ops.prng import uniform_index

_MISSIONS = {
    "lava": mission_vec(template_id("avoid the lava and get to the green goal square")),
    "wall": mission_vec(template_id("find the opening and get to the green goal square")),
}
# Larger than any room limit: pads the sorted river positions.
_BIG = 10**6
# The kernel's slots (csrc/ext/crossing.cuh): rivers, and candidate rows
# plus columns.
MAX_CROSSINGS = 8
MAX_CANDIDATES = 32


class CrossingEnv(MiniGridEnv):
    """Reference: minigrid/envs/crossing.py:122-184."""

    # As in the JAX package; the kernels regenerate its levels themselves,
    # so its plain collector regenerates too instead of reading a cache.
    expensive_reset = True
    # Grids hold only wall, lava and goal cells, and the mission depends
    # only on the obstacle type.
    fused_no_objects = True
    fused_static_mission = True

    def __init__(
        self,
        size: int = 9,
        num_crossings: int = 1,
        obstacle_type: str = "lava",
        max_steps: int | None = None,
        **kwargs,
    ):
        if size % 2 != 1:
            raise ValueError(f"size must be odd, got {size}")
        if obstacle_type not in _MISSIONS:
            raise ValueError(f"obstacle_type must be 'lava' or 'wall', got {obstacle_type!r}")
        if max_steps is None:
            max_steps = 4 * size**2
        super().__init__(
            width=size, height=size, max_steps=max_steps, see_through_walls=False, **kwargs
        )
        self.obstacle_type = obstacle_type
        self.num_crossings = int(num_crossings)
        self.fused_ext = _CrossingResetExt()


class _CrossingResetExt(fx.FusedExt):
    """Counter-reset twin of the Crossing generator, draw for draw as
    ``minigrid_tpu/envs/crossing.py:172-290``: river choice (an ordered
    sample without replacement of the candidate rows and columns), the
    sorted river positions, the rivers, the shuffled path of room moves and
    one opening per crossed river.  Words come in the order sel, path,
    open, from ``place_draw`` pairs.  Identity step hooks."""

    covers_reset = True
    kernel_id = 2
    # Its reset writes neither contents nor mission.
    kernel_switches = (True, True, None)

    def kernel_params(self, env) -> tuple[int, ...] | None:
        candidates = len(range(2, env.height - 2, 2)) + len(range(2, env.width - 2, 2))
        if not env.num_crossings <= min(MAX_CROSSINGS, candidates) or candidates > MAX_CANDIDATES:
            return None
        obstacle = LAVA_CELL if env.obstacle_type == "lava" else WALL_CELL
        return (env.max_steps, 0, env.num_crossings, obstacle, 1, 1, 0)

    def reset_block(self, env, seeds, ep_idx) -> EnvState:
        n, w, h, kc = seeds.shape[0], env.width, env.height, env.num_crossings
        device = seeds.device
        obstacle = LAVA_CELL if env.obstacle_type == "lava" else WALL_CELL
        e0, e1 = fx.episode_seed(seeds, ep_idx)
        words = fx.place_words(e0, e1, 3 * kc)
        sel_bits, path_bits, open_bits = words[:kc], words[kc : 2 * kc], words[2 * kc :]
        rows = torch.arange(n, device=device)

        # Ordered sample of kc distinct candidates: vertical rivers at
        # x in {2, 4, ...}, then horizontal ones at y in {2, 4, ...}.
        v_cand, h_cand = list(range(2, h - 2, 2)), list(range(2, w - 2, 2))
        cand = torch.tensor(v_cand + h_cand, device=device)
        chosen = torch.zeros(n, len(cand), dtype=torch.bool, device=device)
        pos, is_v = [], []
        for t in range(kc):
            j = fx.nth_true_index(~chosen, uniform_index(sel_bits[t], len(cand) - t), 0)
            chosen[rows, j] = True
            pos.append(cand[j])
            is_v.append(j < len(v_cand))
        pos_t = torch.stack(pos, dim=1) if kc else torch.zeros(n, 0, dtype=torch.long, device=device)
        is_v_t = torch.stack(is_v, dim=1) if kc else torch.zeros(n, 0, dtype=torch.bool, device=device)
        rv = torch.where(is_v_t, pos_t, _BIG).sort(dim=1).values
        rh = torch.where(is_v_t, _BIG, pos_t).sort(dim=1).values
        n_v = is_v_t.sum(dim=1)

        # The walls-and-goal scaffold, then the rivers.
        plane = fx.walled_plane(n, w, h, device, [(w - 2, h - 2, GOAL_CELL)])
        xs = (torch.arange(w * h, device=device) // h)[None, :]
        ys = (torch.arange(w * h, device=device) % h)[None, :]
        for t in range(kc):
            p, v = pos_t[:, t : t + 1], is_v_t[:, t : t + 1]
            vmask = (xs == p) & (ys >= 1) & (ys <= h - 2)
            hmask = (ys == p) & (xs >= 1) & (xs <= w - 2)
            plane = torch.where((v & vmask) | (~v & hmask), obstacle, plane)

        # Room limits [0] + rivers + [edge] (reference :160-161).
        def limits(rs, count, edge):
            i = torch.arange(1, kc + 1, device=device)[None, :]
            inner = torch.where(i <= count[:, None], rs, edge)
            zero = torch.zeros(n, 1, dtype=torch.long, device=device)
            return torch.cat([zero, inner, zero + edge], dim=1)

        lv = limits(rv, n_v, h - 1)
        lh = limits(rh, kc - n_v, w - 1)

        def at(table, i):
            return table.gather(1, i[:, None])[:, 0]

        # The path: n_v horizontal moves among kc, drawn as a sequential
        # multiset permutation; each move opens one cell of the river it
        # crosses.
        remaining_h = n_v
        room_i = torch.zeros(n, dtype=torch.long, device=device)
        room_j = torch.zeros_like(room_i)
        for t in range(kc):
            hmove = uniform_index(path_bits[t], kc - t) < remaining_h
            remaining_h = remaining_h - hmove.long()
            lo_h, hi_h = at(lh, room_j) + 1, at(lh, room_j + 1)
            y_h = lo_h + uniform_index(open_bits[t], (hi_h - lo_h).clamp(min=1))
            lo_v, hi_v = at(lv, room_i) + 1, at(lv, room_i + 1)
            x_v = lo_v + uniform_index(open_bits[t], (hi_v - lo_v).clamp(min=1))
            x = torch.where(hmove, at(lv, room_i + 1), x_v)
            y = torch.where(hmove, y_h, at(lh, room_j + 1))
            plane[rows, x * h + y] = EMPTY_CELL
            room_i = room_i + hmove.long()
            room_j = room_j + (~hmove).long()

        return new_state(
            plane.reshape(n, w, h), (1, 1), 0, env.max_steps, mission=_MISSIONS[env.obstacle_type]
        )
