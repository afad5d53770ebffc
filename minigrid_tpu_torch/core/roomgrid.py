"""Batched RoomGrid builder.

Counterpart of ``minigrid_tpu/core/roomgrid.py`` (the reference's mutable
``RoomGrid``, minigrid/core/roomgrid.py:66-438).  The lattice is static
(``room_size``, ``num_rows``, ``num_cols`` are ints on the builder); the
construction state of N levels at once is a ``RoomGridState`` of tensors
with a leading env axis, threaded through RoomGridBuilder's methods.  Room
coordinates ``i`` (column) and ``j`` (row) and wall indices ``k`` are ints
or int32 [N] tensors.

Every draw comes from the caller's ``torch.Generator`` through
``core/sampling.py``: a uniform choice among the cells (or wall slots, or
(kind, color) pairs) that the reference's rejection loop would accept, one
row per env.  The port cannot replay ``jax.random``, so the drawing methods
are held to the JAX package's by distribution; ``reach_mask``,
``_room_components``, ``door_slot``, ``open_all_doors`` and
``agent_room_mask`` are deterministic and bit-exact with it.

Wall slots: the lattice shares each door position between two rooms, so
connectivity is stored per slot: ``door_y[n, j, i]`` is the y of the slot in
the right wall of room (i, j) (i < num_cols-1), ``door_x[n, j, i]`` the x of
the slot in its bottom wall (j < num_rows-1); ``open_right``/``open_down``
say whether a door was put there or the wall removed, and ``locked[n, j, i]``
that room (i, j) is behind a locked door (reference :260).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from minigrid_tpu_torch.core import grid as g
from minigrid_tpu_torch.core import sampling as s_
from minigrid_tpu_torch.core.constants import (
    EMPTY_CELL,
    OBJ_BALL,
    OBJ_BOX,
    OBJ_DOOR,
    OBJ_EMPTY,
    OBJ_KEY,
    OBJ_WALL,
    SORTED_COLOR_IDX,
    STATE_CLOSED,
    STATE_LOCKED,
    WALL_CELL,
    cell,
    cell_type,
)

# Object kinds in the reference's draw order ["key", "ball", "box"]
# (minigrid/core/roomgrid.py:210), and the 18 (kind, color) pairs.
KIND_TABLE = (OBJ_KEY, OBJ_BALL, OBJ_BOX)
COMBO_KIND = tuple(k for k in KIND_TABLE for _ in SORTED_COLOR_IDX)
COMBO_COLOR = SORTED_COLOR_IDX * len(KIND_TABLE)
# Wall k of a room: 0 right, 1 down, 2 left, 3 up (DIR_TO_VEC order).
_WALL_VEC = ((1, 0), (0, 1), (-1, 0), (0, -1))


@dataclass
class RoomGridState:
    """Construction state of N levels (the lattice geometry is static on
    the builder)."""

    grid: torch.Tensor  # int32 [N, W, H] packed
    door_y: torch.Tensor  # int32 [N, rows, cols]
    door_x: torch.Tensor  # int32 [N, rows, cols]
    open_right: torch.Tensor  # bool [N, rows, cols]
    open_down: torch.Tensor  # bool [N, rows, cols]
    locked: torch.Tensor  # bool [N, rows, cols]
    combo_present: torch.Tensor  # bool [N, 18]: (kind, color) pairs placed
    agent_pos: torch.Tensor  # int32 [N, 2]
    agent_dir: torch.Tensor  # int32 [N]
    # False once a placement found no free cell: the reference's place_obj
    # RecursionError (minigrid/minigrid_env.py:339-343), which aborts the
    # generation attempt; RoomGridLevel folds it into the attempt's
    # validity and draws again.
    ok: torch.Tensor  # bool [N]

    def replace(self, **changes) -> RoomGridState:
        return dataclasses.replace(self, **changes)


def _lanes(v, n: int, device) -> torch.Tensor:
    """An int or an int [N] tensor as int64 [N]."""
    return torch.as_tensor(v, device=device).long().expand(n)


def _per_env(v):
    return v[:, None, None] if isinstance(v, torch.Tensor) else v


def _combo_index(kind: torch.Tensor, color: torch.Tensor) -> torch.Tensor:
    """int64 [N]: index into the 18 (kind, color) pairs."""
    kind_idx = torch.where(kind == OBJ_KEY, 0, torch.where(kind == OBJ_BALL, 1, 2))
    table = torch.tensor(SORTED_COLOR_IDX, dtype=torch.int32, device=kind.device)
    sorted_pos = (table[None, :] == color[:, None]).int().argmax(dim=-1)
    return (kind_idx * len(SORTED_COLOR_IDX) + sorted_pos).long()


def _table(values, idx: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int32, device=idx.device)[idx.long()]


class RoomGridBuilder:
    """Static lattice geometry and the construction methods."""

    def __init__(self, room_size: int, num_rows: int, num_cols: int):
        if room_size < 3:
            raise ValueError(f"room_size must be >= 3, got {room_size}")
        self.room_size = room_size
        self.num_rows = num_rows
        self.num_cols = num_cols
        self.width = (room_size - 1) * num_cols + 1
        self.height = (room_size - 1) * num_rows + 1

    # -- lattice geometry --------------------------------------------------
    def room_top(self, i, j):
        rs = self.room_size - 1
        return i * rs, j * rs

    def room_of_pos(self, x, y):
        rs = self.room_size - 1
        return x // rs, y // rs

    def init(self, generator: torch.Generator | None, n: int, device) -> RoomGridState:
        """Lattice walls and one door slot per interior wall (reference
        :123-179); the agent at the middle room's centre, facing east."""
        rs = self.room_size - 1
        w, h, r, c = self.width, self.height, self.num_rows, self.num_cols
        xs, ys = g.coord_grids(w, h, device)
        grid = g.put(g.empty_grid(n, w, h, device), (xs % rs == 0) | (ys % rs == 0), WALL_CELL)
        # Right-wall y in [top+1, top+rs), bottom-wall x likewise (:159-164).
        y_base = (torch.arange(r, dtype=torch.int32, device=device) * rs)[None, :, None]
        x_base = (torch.arange(c, dtype=torch.int32, device=device) * rs)[None, None, :]
        door_y = y_base + s_.randint(generator, n * r * c, 1, rs, device).reshape(n, r, c)
        door_x = x_base + s_.randint(generator, n * r * c, 1, rs, device).reshape(n, r, c)
        start = ((c // 2) * rs + self.room_size // 2, (r // 2) * rs + self.room_size // 2)
        false = torch.zeros((n, r, c), dtype=torch.bool, device=device)
        return RoomGridState(
            grid=grid,
            door_y=door_y,
            door_x=door_x,
            open_right=false,
            open_down=false.clone(),
            locked=false.clone(),
            combo_present=torch.zeros((n, len(COMBO_KIND)), dtype=torch.bool, device=device),
            agent_pos=torch.tensor(start, dtype=torch.int32, device=device).expand(n, 2).contiguous(),
            agent_dir=torch.zeros(n, dtype=torch.int32, device=device),
            ok=torch.ones(n, dtype=torch.bool, device=device),
        )

    # -- door slots ----------------------------------------------------------
    def door_slot(self, s: RoomGridState, i, j, k):
        """(x, y) of the slot on wall ``k`` of room (i, j), whether the wall
        has a neighbour, and the slot's owner room (oi, oj) with whether it
        is a right wall: int32 x, y, bool valid, int64 oi, oj, bool
        horizontal, each [N]."""
        n, device = s.grid.shape[0], s.grid.device
        rs = self.room_size - 1
        i, j, k = (_lanes(v, n, device) for v in (i, j, k))
        # Left and top walls belong to the left and top neighbours.
        oi = torch.where(k == 2, i - 1, i)
        oj = torch.where(k == 3, j - 1, j)
        oi_c = oi.clamp(0, self.num_cols - 1)
        oj_c = oj.clamp(0, self.num_rows - 1)
        horizontal = (k == 0) | (k == 2)
        rows = torch.arange(n, device=device)
        x = torch.where(horizontal, (oi_c + 1) * rs, s.door_x[rows, oj_c, oi_c].long())
        y = torch.where(horizontal, s.door_y[rows, oj_c, oi_c].long(), (oj_c + 1) * rs)
        valid = torch.where(
            horizontal,
            (oi >= 0) & (oi < self.num_cols - 1) & (j >= 0) & (j < self.num_rows),
            (oj >= 0) & (oj < self.num_rows - 1) & (i >= 0) & (i < self.num_cols),
        )
        return x.int(), y.int(), valid, oi_c, oj_c, horizontal

    def _slot_open(self, s: RoomGridState, oi, oj, horizontal) -> torch.Tensor:
        rows = torch.arange(s.grid.shape[0], device=s.grid.device)
        return torch.where(horizontal, s.open_right[rows, oj, oi], s.open_down[rows, oj, oi])

    def wall_open(self, s: RoomGridState, i, j, k) -> torch.Tensor:
        _, _, valid, oi, oj, horizontal = self.door_slot(s, i, j, k)
        return valid & self._slot_open(s, oi, oj, horizontal)

    def _set_wall_open(self, s: RoomGridState, i, j, k) -> RoomGridState:
        _, _, _, oi, oj, horizontal = self.door_slot(s, i, j, k)
        rows = torch.arange(s.grid.shape[0], device=s.grid.device)
        open_right, open_down = s.open_right.clone(), s.open_down.clone()
        open_right[rows, oj, oi] |= horizontal
        open_down[rows, oj, oi] |= ~horizontal
        return s.replace(open_right=open_right, open_down=open_down)

    def random_free_wall(self, generator, s: RoomGridState, i, j) -> torch.Tensor:
        """A uniform wall of room (i, j) with a neighbour and no door yet
        (the reference's add_door rejection loop, :244-250); int64 [N]."""
        valid = []
        for k in range(4):
            _, _, v, oi, oj, horizontal = self.door_slot(s, i, j, k)
            valid.append(v & ~self._slot_open(s, oi, oj, horizontal))
        return s_.masked_uniform_index(generator, torch.stack(valid, dim=1))

    def add_door(self, generator, s: RoomGridState, i, j, k=None, color=None, locked=None):
        """A door on wall ``k`` of room (i, j) (reference :230-274), a
        random free wall where ``k`` is None, of a random color and locked
        with probability 1/2 unless given.  Returns (state, color int32 [N],
        position int32 [N, 2])."""
        n, device = s.grid.shape[0], s.grid.device
        if k is None:
            k = self.random_free_wall(generator, s, i, j)
        if color is None:
            color = _table(SORTED_COLOR_IDX, s_.randint(generator, n, 0, len(SORTED_COLOR_IDX), device))
        color = _lanes(color, n, device).int()
        if locked is None:
            locked = s_.randint(generator, n, 0, 2, device) == 0  # the reference's _rand_bool
        locked = torch.as_tensor(locked, device=device).bool().expand(n)
        x, y, _, _, _, _ = self.door_slot(s, i, j, k)
        door_state = torch.where(locked, STATE_LOCKED, STATE_CLOSED).int()
        s = s.replace(grid=g.set_cell(s.grid, x, y, cell(OBJ_DOOR, color, door_state)))
        s = self._set_wall_open(s, i, j, k)
        # room.locked is set on the room add_door was called on (:260).
        ii = _lanes(i, n, device).clamp(0, self.num_cols - 1)
        jj = _lanes(j, n, device).clamp(0, self.num_rows - 1)
        new_locked = s.locked.clone()
        new_locked[torch.arange(n, device=device), jj, ii] = locked
        return s.replace(locked=new_locked), color, torch.stack([x, y], dim=-1)

    def remove_wall(self, s: RoomGridState, i, j, k) -> RoomGridState:
        """Clear the interior cells of wall ``k`` of room (i, j) (reference
        :276-311)."""
        n, device = s.grid.shape[0], s.grid.device
        rs = self.room_size - 1
        i, j, k = (_lanes(v, n, device) for v in (i, j, k))
        tx, ty = (_per_env(v) for v in self.room_top(i, j))
        k3 = _per_env(k)
        xs, ys = g.coord_grids(self.width, self.height, device)
        wall_x = torch.where(k3 == 0, tx + rs, tx)
        wall_y = torch.where(k3 == 1, ty + rs, ty)
        vmask = (xs == wall_x) & (ys > ty) & (ys < ty + rs)
        hmask = (ys == wall_y) & (xs > tx) & (xs < tx + rs)
        mask = torch.where((k3 == 0) | (k3 == 2), vmask, hmask)
        s = s.replace(grid=g.put(s.grid, mask, EMPTY_CELL))
        return self._set_wall_open(s, i, j, k)

    # -- placement -----------------------------------------------------------
    def room_interior_mask(self, i, j, device=None) -> torch.Tensor:
        """The rectangle of room (i, j), walls included: bool [W, H], or
        [N, W, H] for per-env rooms (on their device, else ``device``)."""
        tx, ty = self.room_top(i, j)
        return g.rect_mask(self.width, self.height, tx, ty, self.room_size, self.room_size, device)

    def _near_agent(self, s: RoomGridState) -> torch.Tensor:
        """Cells within manhattan distance 1 of the agent (reject_next_to,
        reference :11-20)."""
        xs, ys = g.coord_grids(self.width, self.height, s.grid.device)
        ax, ay = _per_env(s.agent_pos[:, 0]), _per_env(s.agent_pos[:, 1])
        return ((xs - ax).abs() + (ys - ay).abs()) < 2

    def place_in_room(self, generator, s: RoomGridState, i, j, cell_value):
        """Put ``cell_value`` (int32 [N]) on a uniform free cell of room
        (i, j) that is not within manhattan distance 1 of the agent
        (reference :181-196).  Returns (state, position int32 [N, 2])."""
        room = self.room_interior_mask(_room_arg(i, s), _room_arg(j, s), s.grid.device)
        m = g.free_mask(s.grid, s.agent_pos) & room & ~self._near_agent(s)
        pos = s_.sample_mask_cell(generator, m)
        grid = g.set_cell(s.grid, pos[:, 0], pos[:, 1], cell_value)
        return s.replace(grid=grid, ok=s.ok & m.flatten(1).any(dim=1)), pos

    def _mark_combo(self, s: RoomGridState, kind, color) -> RoomGridState:
        present = s.combo_present.clone()
        present[torch.arange(kind.shape[0], device=kind.device), _combo_index(kind, color)] = True
        return s.replace(combo_present=present)

    def add_object(self, generator, s: RoomGridState, i, j, kind=None, color=None):
        """A key, ball or box of the given or a random kind and color in
        room (i, j) (reference :198-228).  Returns (state, kind, color int32
        [N], position int32 [N, 2])."""
        n, device = s.grid.shape[0], s.grid.device
        if kind is None:
            kind = _table(KIND_TABLE, s_.randint(generator, n, 0, len(KIND_TABLE), device))
        if color is None:
            color = _table(SORTED_COLOR_IDX, s_.randint(generator, n, 0, len(SORTED_COLOR_IDX), device))
        kind, color = _lanes(kind, n, device).int(), _lanes(color, n, device).int()
        s, pos = self.place_in_room(generator, s, i, j, cell(kind, color))
        return self._mark_combo(s, kind, color), kind, color, pos

    def place_agent(self, generator, s: RoomGridState, i=None, j=None) -> RoomGridState:
        """The agent in room (i, j), a random room where not given, on a free
        cell facing an empty or wall cell (reference :313-334).  The
        reference proposes (position, direction) pairs and rejects; this
        draws uniformly from the accepted pairs."""
        n, device = s.grid.shape[0], s.grid.device
        if i is None:
            i = s_.randint(generator, n, 0, self.num_cols, device)
        if j is None:
            j = s_.randint(generator, n, 0, self.num_rows, device)
        w, h = self.width, self.height
        free = g.free_mask(s.grid) & self.room_interior_mask(_room_arg(i, s), _room_arg(j, s), device)
        t = cell_type(s.grid)
        front_ok = ((t == OBJ_EMPTY) | (t == OBJ_WALL)).to(torch.uint8)
        padded = torch.nn.functional.pad(front_ok, (1, 1, 1, 1), value=1).bool()
        # front[n, x, y, d]: the cell one step from (x, y) in direction d;
        # free cells are inside the border, so the shifted reads stay in the grid.
        front = torch.stack([padded[:, 1 + dx : 1 + dx + w, 1 + dy : 1 + dy + h] for dx, dy in _WALL_VEC], dim=-1)
        m = free[..., None] & front
        idx = s_.masked_uniform_index(generator, m.reshape(n, -1))
        xy = idx // 4
        pos = torch.stack([xy // h, xy % h], dim=-1).int()
        return s.replace(agent_pos=pos, agent_dir=(idx % 4).int(), ok=s.ok & m.flatten(1).any(dim=1))

    def agent_room_mask(self, s: RoomGridState) -> torch.Tensor:
        """bool [N, W, H]: the rectangle (walls included) of the agent's room
        (the reference's Room.pos_inside, minigrid/core/roomgrid.py:49-63)."""
        ai, aj = self.room_of_pos(s.agent_pos[:, 0], s.agent_pos[:, 1])
        return self.room_interior_mask(ai, aj)

    def open_all_doors(self, s: RoomGridState) -> RoomGridState:
        """Every door's state set to open (reference
        minigrid/envs/babyai/core/roomgrid_level.py:237-247)."""
        is_door = cell_type(s.grid) == OBJ_DOOR
        return s.replace(grid=torch.where(is_door, s.grid & 0xFFFF, s.grid))

    # -- connectivity ------------------------------------------------------
    def reach_mask(self, s: RoomGridState) -> torch.Tensor:
        """bool [N, rows, cols]: the rooms reachable from the agent's room
        through open wall slots (the reference's find_reach, :348-359;
        locked doors count as connections)."""
        r, c = self.num_rows, self.num_cols
        device = s.grid.device
        ai, aj = self.room_of_pos(s.agent_pos[:, 0], s.agent_pos[:, 1])
        cols = torch.arange(c, device=device)[None, None, :]
        rows = torch.arange(r, device=device)[None, :, None]
        reach = (cols == ai[:, None, None]) & (rows == aj[:, None, None])
        for _ in range(r * c):
            grown = reach.clone()
            grown[:, :, 1:] |= reach[:, :, :-1] & s.open_right[:, :, :-1]
            grown[:, :, :-1] |= reach[:, :, 1:] & s.open_right[:, :, :-1]
            grown[:, 1:, :] |= reach[:, :-1, :] & s.open_down[:, :-1, :]
            grown[:, :-1, :] |= reach[:, 1:, :] & s.open_down[:, :-1, :]
            reach = grown
        return reach

    def _room_components(self, s: RoomGridState) -> torch.Tensor:
        """int32 [N, rows, cols] connected-component labels over open wall
        slots (min-label propagation; the lattice's diameter bounds the
        rounds)."""
        r, c = self.num_rows, self.num_cols
        n, device = s.grid.shape[0], s.grid.device
        lab = torch.arange(r * c, dtype=torch.int32, device=device).reshape(1, r, c).expand(n, r, c).contiguous()
        big = torch.tensor(r * c + 1, dtype=torch.int32, device=device)
        for _ in range(r + c):
            right = torch.where(s.open_right[:, :, : c - 1], lab[:, :, 1:], big)
            left = torch.where(s.open_right[:, :, : c - 1], lab[:, :, : c - 1], big)
            down = torch.where(s.open_down[:, : r - 1, :], lab[:, 1:, :], big)
            up = torch.where(s.open_down[:, : r - 1, :], lab[:, : r - 1, :], big)
            m = lab.clone()
            m[:, :, : c - 1] = torch.minimum(m[:, :, : c - 1], right)
            m[:, :, 1:] = torch.minimum(m[:, :, 1:], left)
            m[:, : r - 1, :] = torch.minimum(m[:, : r - 1, :], down)
            m[:, 1:, :] = torch.minimum(m[:, 1:, :], up)
            lab = m
        return lab

    def connect_all(self, generator, s: RoomGridState, door_colors=None, max_itrs: int | None = None, exclude_color=None):
        """Add closed doors at random until every room is reachable
        (reference :336-394).  The reference draws (i, j, k) and skips
        missing, taken and locked slots; each accepted draw is uniform over
        the slots still addable (not open, neither side locked), so each
        round draws from that set directly, for the envs not yet connected,
        and merges the two sides' component labels.  ``exclude_color`` (an
        int or int32 [N], -1 for none) removes one color from the palette
        (BabyAI Unlock, babyai/unlock.py:83-88)."""
        r, c = self.num_rows, self.num_cols
        if r * (c - 1) + (r - 1) * c == 0:
            return s  # one room: no interior wall
        n, device = s.grid.shape[0], s.grid.device
        rs = self.room_size - 1
        colors = SORTED_COLOR_IDX if door_colors is None else tuple(int(x) for x in door_colors)
        table = torch.tensor(colors, dtype=torch.int32, device=device)
        excl = _lanes(-1 if exclude_color is None else exclude_color, n, device).int()
        has_excl = (table[None, :] == excl[:, None]).any(dim=1)
        excl_pos = (table[None, :] == excl[:, None]).int().argmax(dim=1)
        if max_itrs is None:
            max_itrs = 4 * r * c  # every slot can take a door once
        rows = torch.arange(n, device=device)
        n_right = r * (c - 1)
        lab = self._room_components(s)
        grid, open_right, open_down = s.grid, s.open_right.clone(), s.open_down.clone()
        for _ in range(max_itrs):
            active = ~(lab == lab[:, :1, :1]).flatten(1).all(dim=1)
            if not bool(active.any()):
                break
            right_ok = ~open_right[:, :, : c - 1] & ~s.locked[:, :, : c - 1] & ~s.locked[:, :, 1:]
            down_ok = ~open_down[:, : r - 1, :] & ~s.locked[:, : r - 1, :] & ~s.locked[:, 1:, :]
            flat = torch.cat([right_ok.reshape(n, -1), down_ok.reshape(n, -1)], dim=1)
            pick = s_.masked_uniform_index(generator, flat)
            is_right = pick < n_right
            down_pick = (pick - n_right).clamp(min=0)
            oj = torch.where(is_right, pick // max(c - 1, 1), down_pick // c).clamp(0, r - 1)
            oi = torch.where(is_right, pick % max(c - 1, 1), down_pick % c).clamp(0, c - 1)
            x = torch.where(is_right, (oi + 1) * rs, _at(s.door_x, rows, oj, oi))
            y = torch.where(is_right, _at(s.door_y, rows, oj, oi), (oj + 1) * rs)
            r_full = s_.randint(generator, n, 0, len(colors), device)
            r_less = s_.randint(generator, n, 0, max(len(colors) - 1, 1), device)
            color = table[torch.where(has_excl, r_less + (r_less >= excl_pos).int(), r_full).long()]
            do = flat.any(dim=1) & active
            door = g.cell_mask(grid, x, y) & do[:, None, None]
            grid = torch.where(door, _per_env(cell(OBJ_DOOR, color, STATE_CLOSED)), grid)
            open_right[rows, oj, oi] |= do & is_right
            open_down[rows, oj, oi] |= do & ~is_right
            # Merge the two components.
            nj = torch.where(is_right, oj, oj + 1).clamp(max=r - 1)
            ni = torch.where(is_right, oi + 1, oi).clamp(max=c - 1)
            la, lb = lab[rows, oj, oi], lab[rows, nj, ni]
            lo, hi = torch.minimum(la, lb), torch.maximum(la, lb)
            lab = torch.where(do[:, None, None] & (lab == hi[:, None, None]), lo[:, None, None], lab)
        return s.replace(grid=grid, open_right=open_right, open_down=open_down)

    def add_distractors(self, generator, s: RoomGridState, i=None, j=None, num_distractors: int = 10, all_unique: bool = True):
        """``num_distractors`` random objects, each in room (i, j) or, where
        not given, in a uniform random room, placed one after another as the
        reference does (:396-438); with ``all_unique`` each (kind, color)
        pair is drawn uniformly from those not yet in the level.  Returns
        (state, kinds int32 [N, n], colors int32 [N, n], positions int32
        [N, n, 2])."""
        n, device = s.grid.shape[0], s.grid.device
        kinds, colors, positions = [], [], []
        for _ in range(num_distractors):
            if all_unique:
                combo = s_.masked_uniform_index(generator, ~s.combo_present)
                kind, color = _table(COMBO_KIND, combo), _table(COMBO_COLOR, combo)
            else:
                kind = _table(KIND_TABLE, s_.randint(generator, n, 0, len(KIND_TABLE), device))
                color = _table(SORTED_COLOR_IDX, s_.randint(generator, n, 0, len(SORTED_COLOR_IDX), device))
            ri = s_.randint(generator, n, 0, self.num_cols, device) if i is None else i
            rj = s_.randint(generator, n, 0, self.num_rows, device) if j is None else j
            s, kind, color, pos = self.add_object(generator, s, ri, rj, kind, color)
            kinds.append(kind)
            colors.append(color)
            positions.append(pos)
        if not kinds:
            empty = torch.zeros((n, 0), dtype=torch.int32, device=device)
            return s, empty, empty.clone(), torch.zeros((n, 0, 2), dtype=torch.int32, device=device)
        return s, torch.stack(kinds, 1), torch.stack(colors, 1), torch.stack(positions, 1)


def _room_arg(v, s: RoomGridState):
    """A room coordinate as the rectangle masks take it: an int, or an
    int32 [N] tensor."""
    return v if isinstance(v, int) else _lanes(v, s.grid.shape[0], s.grid.device).int()


def _at(table: torch.Tensor, rows, oj, oi) -> torch.Tensor:
    """``table[n, oj[n], oi[n]]`` per env, as int64."""
    return table[rows, oj, oi].long()
