"""Oracle planner that solves BabyAI levels over the batched engine.

Counterpart of ``minigrid_tpu/utils/babyai_bot.py`` (the reference's
stack-of-subgoals bot, minigrid/utils/baby_ai_bot.py:549-1026).  The world
is this package's ``EnvState`` with a batch of one (env 0 is the episode,
as in ``utils/debug.py``) and the instruction its fixed-slot ``InstrState``
(``envs/babyai/core/instr.py``).  The planner is host-side numpy: a test
oracle and demonstration generator, not part of the device hot path.  Each
``replan`` reads the state back from its device once (``_sync``) and works
on that host copy, the visibility through the plain observation functions
of ``ops/obs_packed.py`` on CPU tensors.

Usage::

    bot = BabyAIBot(env, state)        # state: a batch of one right after reset
    while True:
        action = bot.replan(state, last_action)
        state, reward = env.step_env(state, torch.tensor([action], ...))

The planner maintains a stack of subgoals seeded from the instruction
(navigate / pickup / drop / open / explore), replans when the path is
blocked or the target is unseen, and can advise a suboptimal agent by
passing the action it actually took (DAgger-style, like the reference).
"""

from __future__ import annotations

from collections import deque
from typing import Callable

import numpy as np
import torch

from minigrid_tpu_torch.core.actions import Actions
from minigrid_tpu_torch.core.constants import (
    OBJ_BOX,
    OBJ_DOOR,
    OBJ_EMPTY,
    OBJ_KEY,
    OBJ_WALL,
    STATE_CLOSED,
    STATE_LOCKED,
    STATE_OPEN,
    cell_state,
    cell_type,
    see_behind,
    unpack_grid,
)
from minigrid_tpu_torch.envs.babyai.core.instr import (
    LEAF_GOTO,
    LEAF_NONE,
    LEAF_OPEN,
    LEAF_PICKUP,
    LEAF_PUTNEXT,
    TOP_ACTION,
    TOP_AFTER,
    TOP_AND,
    TOP_BEFORE,
)
from minigrid_tpu_torch.ops.obs_packed import extract_view, process_vis, view_world_coords

# Direction index -> unit vector, as plain tuples for host-side math.
_DIR_VEC = ((1, 0), (0, 1), (-1, 0), (0, -1))
# Bit leaf*2 + slot of a packed tracking plane, as [4, 2, 1, 1].
_SLOT_BITS = np.arange(4)[:, None, None, None] * 2 + np.arange(2)[None, :, None, None]


class DisappearedBoxError(Exception):
    """Raised when a box is toggled open — the tracked object vanished and
    the bot conservatively declares the mission unsolvable (reference:
    minigrid/utils/baby_ai_bot.py:18-28)."""


class _TrackedDesc:
    """Object descriptor backed by the verifier's live tracking plane.

    ``InstrState.gridm[leaf, slot]`` marks the current grid cells of the
    objects matched at reset (identity tracking lives in the verifier, so
    the bot reads it instead of re-deriving it)."""

    def __init__(self, leaf: int, slot: int):
        self.leaf = leaf
        self.slot = slot

    def positions(self, bot: "BabyAIBot") -> list[tuple[int, int]]:
        plane = np.asarray(bot.instr_gridm[self.leaf, self.slot])
        return [tuple(p) for p in np.argwhere(plane)]


class _KeyDesc:
    """Live descriptor for 'a <color> key', matched against the true grid
    each query (the bot invents these while planning door unlocks)."""

    def __init__(self, color: int):
        self.color = color

    def positions(self, bot: "BabyAIBot") -> list[tuple[int, int]]:
        g = bot.grid
        m = (g[:, :, 0] == OBJ_KEY) & (g[:, :, 1] == self.color)
        return [tuple(p) for p in np.argwhere(m)]


class _Subgoal:
    """One plan-stack entry. ``plan(action)`` is the post-action fixup;
    ``advise()`` returns a suggested action or None after mutating the
    stack (the pair mirrors replan_after_action / replan_before_action)."""

    exploratory = False

    def __init__(self, bot: "BabyAIBot", datum=None, reason=None):
        self.bot = bot
        self.datum = datum
        self.reason = reason

    def advise(self):
        raise NotImplementedError

    def plan(self, action_taken):
        pass

    # -- shared helpers ------------------------------------------------------
    def _undo(self, action_taken):
        """Push subgoals that revert an off-plan action (reference
        baby_ai_bot.py:110-148)."""
        bot = self.bot
        if action_taken == Actions.forward:
            if bot.prev_pos != bot.pos:
                bot.stack.append(GoNextTo(bot, bot.pos))
        elif action_taken == Actions.left:
            bot.stack.append(GoNextTo(bot, _add(bot.pos, bot.right_vec)))
        elif action_taken == Actions.right:
            bot.stack.append(GoNextTo(bot, _sub(bot.pos, bot.right_vec)))
        elif action_taken == Actions.drop and bot.prev_carrying != bot.carrying:
            bot.stack.append(Pickup(bot))
        elif action_taken == Actions.pickup and bot.prev_carrying != bot.carrying:
            bot.stack.append(Drop(bot))
        elif action_taken == Actions.toggle:
            fx, fy = bot.fwd_pos
            cell = bot.cell(fx, fy)
            if (
                cell is not None
                and cell[0] == OBJ_DOOR
                and bot.fwd_door_was_open != (cell[2] == STATE_OPEN)
            ):
                bot.stack.append(
                    Close(bot) if cell[2] == STATE_OPEN else Open(bot)
                )


def _add(a, b):
    return (a[0] + b[0], a[1] + b[1])


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1])


def _manhattan(a, b):
    return abs(a[0] - b[0]) + abs(a[1] - b[1])


def _expect(cond: bool, what: str) -> None:
    """A planner invariant; ``AssertionError`` where it fails, as the JAX
    package's ``assert`` raises (and also under ``python -O``)."""
    if not cond:
        raise AssertionError(what)


class Close(_Subgoal):
    def advise(self):
        cell = self.bot.fwd_cell()
        _expect(cell is not None and cell[0] == OBJ_DOOR and cell[2] == STATE_OPEN, "Close: no open door ahead")
        return Actions.toggle

    def plan(self, action_taken):
        if action_taken is None or action_taken == Actions.toggle:
            self.bot.stack.pop()
        elif action_taken in (Actions.forward, Actions.left, Actions.right):
            self._undo(action_taken)


class Open(_Subgoal):
    """Open (and if necessary unlock) the door the agent faces.  ``reason``
    is None, "Unlock" (drop the key afterwards) or "KeepKey"."""

    def advise(self):
        bot = self.bot
        cell = bot.fwd_cell()
        _expect(cell is not None and cell[0] == OBJ_DOOR, "Open: no door ahead")

        locked = cell[2] == STATE_LOCKED
        has_key = bot.carrying is not None and bot.carrying == (OBJ_KEY, cell[1])
        if locked and not has_key:
            key_desc = _KeyDesc(int(cell[1]))
            bot.stack.pop()
            if bot.carrying is not None:
                # Park the current load, fetch the key, open, then retrieve
                # the parked object (reference baby_ai_bot.py:199-220).
                park = bot._find_drop_pos()
                bot.stack.append(Pickup(bot))
                bot.stack.append(GoNextTo(bot, park))
                bot.stack.append(Open(bot))
                bot.stack.append(GoNextTo(bot, bot.fwd_pos))
                bot.stack.append(Pickup(bot))
                bot.stack.append(GoNextTo(bot, key_desc))
                bot.stack.append(Drop(bot))
                bot.stack.append(GoNextTo(bot, park))
            else:
                bot.stack.append(Open(bot))
                bot.stack.append(GoNextTo(bot, bot.fwd_pos))
                bot.stack.append(Pickup(bot))
                bot.stack.append(GoNextTo(bot, key_desc))
            return None

        if cell[2] == STATE_OPEN:
            bot.stack.append(Close(bot))
            return None

        if locked and self.reason is None:
            bot.stack.pop()
            bot.stack.append(Open(bot, reason="Unlock"))
            return None

        return Actions.toggle

    def plan(self, action_taken):
        bot = self.bot
        if action_taken is None or action_taken == Actions.toggle:
            bot.stack.pop()
            if self.reason == "Unlock":
                # Choose the key's resting place only now — planned earlier,
                # the spot could have been taken meanwhile.
                drop_pos = bot._find_drop_pos()
                bot.stack.append(Drop(bot))
                bot.stack.append(GoNextTo(bot, drop_pos))
        else:
            self._undo(action_taken)


class Drop(_Subgoal):
    def advise(self):
        _expect(self.bot.carrying is not None, "Drop: nothing in hand")
        _expect(self.bot.fwd_cell() is None, "Drop: the cell ahead is taken")
        return Actions.drop

    def plan(self, action_taken):
        if action_taken is None or action_taken == Actions.drop:
            self.bot.stack.pop()
        elif action_taken in (Actions.forward, Actions.left, Actions.right):
            self._undo(action_taken)


class Pickup(_Subgoal):
    def advise(self):
        _expect(self.bot.carrying is None, "Pickup: the hand is full")
        return Actions.pickup

    def plan(self, action_taken):
        if action_taken is None or action_taken == Actions.pickup:
            self.bot.stack.pop()
        elif action_taken in (Actions.left, Actions.right):
            self._undo(action_taken)


class GoNextTo(_Subgoal):
    """Navigate until facing ``datum`` — a position, a descriptor, or (with
    reason="PutNext") an empty cell adjacent to the descriptor's object."""

    @property
    def exploratory(self):
        return self.reason == "Explore"

    def advise(self):
        bot = self.bot
        target_pos = None
        if isinstance(self.datum, (_TrackedDesc, _KeyDesc)):
            target_pos = bot._closest_matching(self.datum, self.reason == "PutNext")
            if target_pos is None:
                bot.stack.append(Explore(bot))
                return None
        else:
            target_pos = tuple(self.datum)

        # Walking toward a locked door empty-handed: commit to fetching the
        # key first (reference baby_ai_bot.py:330-346).
        if self.reason == "Open":
            tcell = bot.cell(*target_pos)
            if (
                tcell is not None
                and tcell[0] == OBJ_DOOR
                and tcell[2] == STATE_LOCKED
                and bot.carrying is None
            ):
                bot.stack.pop()
                bot.stack.append(GoNextTo(bot, target_pos, reason="Open"))
                bot.stack.append(Pickup(bot))
                bot.stack.append(GoNextTo(bot, _KeyDesc(int(tcell[1]))))
                return None

        # Standing on (or next to, for PutNext) the goal cell: step aside.
        if _manhattan(target_pos, bot.pos) == (1 if self.reason == "PutNext" else 0):
            for cand, act in (
                (bot.fwd_pos, Actions.forward),
                (_add(bot.pos, bot.right_vec), Actions.right),
                (_sub(bot.pos, bot.right_vec), Actions.left),
            ):
                c = bot.cell(*cand)
                if c is None or (c[0] == OBJ_DOOR and c[2] == STATE_OPEN):
                    return act
            return Actions.left  # spin and hope

        # Facing the target: done (PutNext wants the faced cell empty).
        if self.reason == "PutNext":
            if _manhattan(target_pos, bot.fwd_pos) == 1:
                if bot.fwd_cell() is None:
                    bot.stack.pop()
                    return None
                fc = bot.fwd_cell()
                if fc[0] == OBJ_DOOR and fc[2] == STATE_OPEN:
                    # Can't drop in a doorway; nudge two cells past it.
                    two_ahead = _add(bot.fwd_pos, bot.dir_vec)
                    bot.stack.append(GoNextTo(bot, two_ahead))
                    return None
        elif tuple(target_pos) == bot.fwd_pos:
            bot.stack.pop()
            return None

        path, _, _ = bot._shortest_path(lambda p, c: p == tuple(target_pos))
        if not path:
            path, _, _ = bot._shortest_path(
                lambda p, c: p == tuple(target_pos), with_blockers=True
            )
        if not path:
            bot.stack.append(Explore(bot))
            return None

        nxt = path[0]
        if nxt == bot.fwd_pos:
            fc = bot.fwd_cell()
            if fc is not None:
                if fc[0] == OBJ_DOOR:
                    _expect(fc[2] != STATE_LOCKED, "GoNextTo: a locked door on the path")
                    if fc[2] != STATE_OPEN:
                        bot.stack.append(Open(bot))
                        return None
                    return Actions.forward
                # A blocker sits in the way: relocate it (reference
                # baby_ai_bot.py:425-447).
                if bot.carrying is not None:
                    park = bot._find_drop_pos()
                    stash = bot._find_drop_pos(park)
                    bot.stack.append(Pickup(bot))
                    bot.stack.append(GoNextTo(bot, park))
                    bot.stack.append(Drop(bot))
                    bot.stack.append(GoNextTo(bot, stash))
                    bot.stack.append(Pickup(bot))
                    bot.stack.append(GoNextTo(bot, bot.fwd_pos))
                    bot.stack.append(Drop(bot))
                    bot.stack.append(GoNextTo(bot, park))
                else:
                    park = bot._find_drop_pos()
                    bot.stack.append(Drop(bot))
                    bot.stack.append(GoNextTo(bot, park))
                    bot.stack.append(Pickup(bot))
                return None
            return Actions.forward

        step_vec = _sub(nxt, bot.pos)
        if step_vec == bot.right_vec:
            return Actions.right
        if step_vec == tuple(-v for v in bot.right_vec):
            return Actions.left
        # Target behind us: turn toward the side with more open space.
        if bot._free_run(bot.pos, tuple(-v for v in bot.right_vec)) > bot._free_run(
            bot.pos, bot.right_vec
        ):
            return Actions.left
        return Actions.right

    def plan(self, action_taken):
        if action_taken in (Actions.pickup, Actions.drop, Actions.toggle):
            self._undo(action_taken)


class Explore(_Subgoal):
    exploratory = True

    def advise(self):
        bot = self.bot
        # Head for the nearest cell we have never observed.
        _, unseen, _ = bot._shortest_path(
            lambda p, c: not bot.vis_mask[p], with_blockers=True
        )
        if unseen is not None:
            bot.stack.append(GoNextTo(bot, unseen, reason="Explore"))
            return None

        # Everything seen: open the nearest closed door.  Preference order
        # improves on the reference (baby_ai_bot.py:504-525): (1) unlocked,
        # (2) locked with its key visible or in hand, (3) any.  Without (2),
        # committing to a locked door whose key hides behind another locked
        # door replans in a cycle (solvable chains always have one door with
        # an available key).
        def closed_unlocked(p, c):
            return c is not None and c[0] == OBJ_DOOR and c[2] == STATE_CLOSED

        def locked_key_available(p, c):
            return (
                c is not None
                and c[0] == OBJ_DOOR
                and c[2] == STATE_LOCKED
                and bot._key_available(c[1])
            )

        def closed_any(p, c):
            return c is not None and c[0] == OBJ_DOOR and c[2] != STATE_OPEN

        _, door_pos, _ = bot._shortest_path(closed_unlocked, with_blockers=True)
        if door_pos is None:
            _, door_pos, _ = bot._shortest_path(locked_key_available, with_blockers=True)
        if door_pos is None:
            _, door_pos, _ = bot._shortest_path(closed_any, with_blockers=True)
        if door_pos is not None:
            dcell = bot.cell(*door_pos)
            has_key = bot.carrying is not None and bot.carrying == (
                OBJ_KEY,
                dcell[1],
            )
            reason = "KeepKey" if dcell[2] == STATE_LOCKED and has_key else None
            bot.stack.pop()
            bot.stack.append(Open(bot, reason=reason))
            bot.stack.append(GoNextTo(bot, door_pos, reason="Open"))
            return None

        raise AssertionError("nothing left to explore")


class BabyAIBot:
    """Solve a BabyAI level by maintaining a subgoal stack over the array
    state (reference: minigrid/utils/baby_ai_bot.py:549)."""

    def __init__(self, env, state):
        self.env = env
        self.view_size = env.agent_view_size
        self.vis_mask = np.zeros(tuple(state.grid.shape[-2:]), dtype=bool)
        self.stack: list[_Subgoal] = []
        self._sync(state)
        self._seed_stack()
        self.prev_pos = self.pos
        self.prev_carrying = self.carrying
        self.prev_fwd_cell = self.fwd_cell()
        self.fwd_door_was_open = False

    # -- per-step state snapshot ------------------------------------------------
    def _sync(self, state):
        """Copy env 0's grid, pose, carried object, tracking plane and
        instruction shape to the host in one transfer."""
        if state.grid.dim() != 3 or state.grid.shape[0] != 1:
            raise ValueError(f"BabyAIBot plans one episode, a batch of one: got grid {tuple(state.grid.shape)}")
        instr = state.extra["instr"]
        w, h = self.vis_mask.shape
        host = torch.cat(
            [
                state.grid[0].reshape(-1),
                instr.gridm[0].reshape(-1),
                torch.stack([state.agent_x[0], state.agent_y[0], state.agent_dir[0], state.carrying[0]]),
                torch.stack([instr.top_kind[0], instr.a_is_and[0].int(), instr.b_is_and[0].int()]),
                instr.leaf_kind[0],
            ]
        ).cpu()
        self.grid_packed = host[: w * h].reshape(1, w, h)
        self.grid = unpack_grid(self.grid_packed[0]).numpy()
        g = host[w * h : 2 * w * h].reshape(w, h).numpy()  # packed int32 [W, H]
        self.instr_gridm = ((g[None, None] >> _SLOT_BITS) & 1) != 0  # bool [4, 2, W, H]
        x, y, d, carry, top, a_and, b_and, *kinds = host[2 * w * h :].tolist()
        self.pos = (x, y)
        self.dir = d
        self.dir_vec = _DIR_VEC[self.dir]
        self.right_vec = (-self.dir_vec[1], self.dir_vec[0])
        self.fwd_pos = _add(self.pos, self.dir_vec)
        self.carrying = (carry & 0xFF, (carry >> 8) & 0xFF) if carry else None
        self.instr_shape = (top, bool(a_and), bool(b_and), kinds)

    def cell(self, x, y):
        """(type, color, state) ints at (x, y), None for empty/out-of-grid."""
        if not (0 <= x < self.grid.shape[0] and 0 <= y < self.grid.shape[1]):
            return (OBJ_WALL, 5, 0)
        c = self.grid[x, y]
        return None if c[0] == OBJ_EMPTY else (int(c[0]), int(c[1]), int(c[2]))

    def fwd_cell(self):
        return self.cell(*self.fwd_pos)

    # -- public API --------------------------------------------------------------
    def replan(self, state, action_taken=None) -> int:
        """Update internal maps from ``state`` and suggest the next action."""
        self._sync(state)
        self._observe()

        if (
            action_taken == Actions.toggle
            and self.prev_fwd_cell is not None
            and self.prev_fwd_cell[0] == OBJ_BOX
        ):
            raise DisappearedBoxError("a tracked box was opened")

        if self.stack:
            self.stack[-1].plan(action_taken)
        while self.stack and self.stack[-1].exploratory:
            self.stack.pop()

        suggested = None
        guard = 0
        while self.stack:
            guard += 1
            if guard > 500:
                raise RuntimeError(
                    "replan cycle: "
                    + repr([(type(s).__name__, s.datum, s.reason) for s in self.stack[-8:]])
                )
            suggested = self.stack[-1].advise()
            if suggested is not None:
                break
        if not self.stack:
            suggested = Actions.done

        self.prev_pos = self.pos
        self.prev_carrying = self.carrying
        fwd = self.fwd_cell()
        if fwd is not None and fwd[0] == OBJ_DOOR:
            self.fwd_door_was_open = fwd[2] == STATE_OPEN
        self.prev_fwd_cell = fwd
        return int(suggested)

    # -- mapping -------------------------------------------------------------------
    def _observe(self):
        """Mark the currently visible cells in the persistent world map
        (reference _process_obs, baby_ai_bot.py:711-739): the view and its
        occlusion flood from the cells as they lie in the grid, through the
        plain observation functions on the host copy."""
        pose = [torch.tensor([v], dtype=torch.int32) for v in (*self.pos, self.dir)]
        cells = extract_view(self.grid_packed, *pose, self.view_size)
        vis = process_vis(see_behind(cell_type(cells), cell_state(cells)))[0].numpy()
        xs, ys = (c[0].numpy() for c in view_world_coords(*pose, self.view_size))
        w, h = self.vis_mask.shape
        ok = vis & (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        self.vis_mask[xs[ok], ys[ok]] = True

    def _key_available(self, color: int) -> bool:
        """A key of ``color`` is in hand or visible somewhere on the map."""
        if self.carrying == (OBJ_KEY, int(color)):
            return True
        g = self.grid
        m = (g[:, :, 0] == OBJ_KEY) & (g[:, :, 1] == color) & self.vis_mask
        return bool(m.any())

    def _in_view(self, x, y):
        vx = (x - self.pos[0]) * self.right_vec[0] + (y - self.pos[1]) * self.right_vec[1]
        vy = (x - self.pos[0]) * self.dir_vec[0] + (y - self.pos[1]) * self.dir_vec[1]
        half = self.view_size // 2
        return -half <= vx <= half and 0 <= vy < self.view_size

    def _free_run(self, position, direction):
        """Steps until the nearest in-view wall/door along ``direction``."""
        d = 1
        while True:
            p = (position[0] + d * direction[0], position[1] + d * direction[1])
            if not self._in_view(*p):
                return d - 1
            c = self.cell(*p)
            if c is not None and c[0] in (OBJ_WALL, OBJ_DOOR):
                return d
            d += 1

    # -- search --------------------------------------------------------------------
    def _bfs(self, starts, accept: Callable, ignore_blockers: bool):
        """Textbook BFS over (pos, incoming dir); straight-ahead neighbors
        enqueue first so paths prefer fewer turns (reference
        baby_ai_bot.py:764-824)."""
        queue = deque((s, None) for s in starts)
        prev: dict = {}
        while queue:
            (i, j, di, dj), parent = queue.popleft()
            if (i, j) in prev:
                continue
            prev[(i, j)] = parent
            c = self.cell(i, j)
            if accept((i, j), c):
                path = []
                p = (i, j)
                while p is not None:
                    path.append(p)
                    p = prev[p]
                return path, (i, j), prev
            if not self.vis_mask[i, j]:
                continue
            if c is not None:
                if c[0] == OBJ_WALL:
                    continue
                if c[0] == OBJ_DOOR:
                    if c[2] != STATE_OPEN:
                        continue
                elif not ignore_blockers:
                    continue
            for k, l in ((di, dj), (dj, di), (-dj, -di), (-di, -dj)):
                queue.append(((i + k, j + l, k, l), (i, j)))
        return None, None, prev

    def _shortest_path(self, accept: Callable, with_blockers: bool = False):
        starts = [(self.pos[0], self.pos[1], self.dir_vec[0], self.dir_vec[1])]
        path, finish, prev = self._bfs(starts, accept, ignore_blockers=False)
        used_blockers = False
        if path is None and with_blockers:
            used_blockers = True
            path, finish, _ = self._bfs(
                [(i, j, 1, 0) for (i, j) in prev], accept, ignore_blockers=True
            )
            if path is not None:
                # Splice the blocker-free prefix back on.
                p = path[-1]
                extra = []
                while p is not None:
                    extra.append(p)
                    p = prev[p]
                path = path + extra[1:]
        if path is not None:
            path = path[::-1][1:]
        return path, finish, used_blockers

    def _closest_matching(self, desc, adjacent: bool):
        """Nearest *seen* object matching ``desc`` (reference _find_obj_pos,
        baby_ai_bot.py:650-709); returns its position or None."""
        best_d, best_pos = 999, None
        for pos in desc.positions(self):
            if not self.vis_mask[pos]:
                continue
            path, _, blocked = self._shortest_path(
                lambda p, c, t=pos: p == t, with_blockers=True
            )
            if path is None:
                continue
            d = len(path)
            if blocked:
                # Un-blocking costs extra turns/carries; use the reference's
                # lower bounds (4 empty-handed, 7 loaded).
                d += 7 if self.carrying is not None else 4
            if d == 0:
                d = 3 if adjacent else 2
            if adjacent and d == 1:
                d = 3
            if d < best_d:
                best_d, best_pos = d, pos
        return best_pos

    def _find_drop_pos(self, except_pos=None):
        """A reachable empty cell to park an object, preferring spots whose
        8-neighborhood stays connected (reference _find_drop_pos,
        baby_ai_bot.py:865-973)."""

        def basic_ok(pos):
            if pos == self.pos:
                return False
            if except_pos is not None and pos == tuple(except_pos):
                return False
            if not self.vis_mask[pos] or self.cell(*pos) is not None:
                return False
            return True

        def non_blocking(pos, _cell):
            if not basic_ok(pos):
                return False
            i, j = pos
            w, h = self.grid.shape[:2]
            exc = tuple(except_pos) if except_pos is not None else None
            ring = []
            for k, l in (
                (-1, -1), (0, -1), (1, -1), (1, 0),
                (1, 1), (0, 1), (-1, 1), (-1, 0),
            ):
                nb = (i + k, j + l)
                inb = 0 <= nb[0] < w and 0 <= nb[1] < h
                seen = inb and self.vis_mask[nb]
                c = self.cell(*nb)
                if seen and c is not None and c[0] == OBJ_WALL:
                    ring.append(1)  # wall
                elif (
                    seen
                    and (
                        c is None
                        or (c[0] == OBJ_DOOR and c[2] == STATE_OPEN)
                        or nb == self.pos
                    )
                    and nb != exc
                ):
                    ring.append(0)  # free
                else:
                    ring.append(2)  # object / unknown
            changes = sum(
                bool(ring[(i + 1) % 8]) != bool(ring[i]) for i in range(8)
            )
            for i in range(8):
                if ring[i] == 2 and ring[i - 1] != 0 and ring[(i + 1) % 8] != 0:
                    return False
            return changes <= 2

        def any_empty(pos, _cell):
            return basic_ok(pos)

        for pred, blockers in (
            (non_blocking, False),
            (any_empty, False),
            (non_blocking, True),
            (any_empty, True),
        ):
            _, drop_pos, _ = self._shortest_path(pred, with_blockers=blockers)
            if drop_pos is not None:
                return drop_pos
        return None

    # -- instruction decomposition ---------------------------------------------
    def _seed_stack(self):
        top, a_is_and, b_is_and, kinds = self.instr_shape

        # Stack executes top-down, so the side pushed LAST runs FIRST.
        # Reference ordering (baby_ai_bot.py:1004-1012): Before/And run the
        # a-side first; After runs the b-side first.  Within an And side the
        # first conjunct runs first, so its leaf is pushed last.
        def leaves_of_side(first: int, is_and: bool):
            return [first + 1, first] if is_and else [first]

        if top == TOP_ACTION:
            order = [0]
        elif top == TOP_AND:
            order = [1, 0]
        elif top == TOP_BEFORE:
            order = leaves_of_side(2, b_is_and) + leaves_of_side(0, a_is_and)
        elif top == TOP_AFTER:
            order = leaves_of_side(0, a_is_and) + leaves_of_side(2, b_is_and)
        else:
            raise ValueError(f"unknown instruction shape {top}")

        for leaf in order:
            kind = kinds[leaf]
            if kind == LEAF_NONE:
                continue
            self._push_leaf(leaf, kind)

    def _push_leaf(self, leaf: int, kind: int):
        desc = _TrackedDesc(leaf, 0)
        if kind == LEAF_GOTO:
            self.stack.append(GoNextTo(self, desc))
        elif kind == LEAF_OPEN:
            self.stack.append(Open(self))
            self.stack.append(GoNextTo(self, desc, reason="Open"))
        elif kind == LEAF_PICKUP:
            # Pick up then immediately drop, freeing the hands for later
            # sub-missions (reference baby_ai_bot.py:989-995).
            self.stack.append(Drop(self))
            self.stack.append(Pickup(self))
            self.stack.append(GoNextTo(self, desc))
        elif kind == LEAF_PUTNEXT:
            self.stack.append(Drop(self))
            self.stack.append(GoNextTo(self, _TrackedDesc(leaf, 1), reason="PutNext"))
            self.stack.append(Pickup(self))
            self.stack.append(GoNextTo(self, desc))
        else:
            raise AssertionError(f"unknown leaf kind {kind}")
