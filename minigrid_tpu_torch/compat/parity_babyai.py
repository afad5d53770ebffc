"""BabyAI seed-parity: host mission generation mirroring the reference's
RNG draw order.

Counterpart of ``minigrid_tpu/compat/parity_babyai.py``.  Extends the
classic-env parity layer (minigrid_tpu_torch/compat/parity.py) to BabyAI
levels: each family's ``gen_mission`` is replayed draw for draw
(reference: minigrid/envs/babyai/{goto,open,pickup,putnext}.py) inside the
``RoomGridLevel._gen_grid`` rejection-resampling loop (reference:
minigrid/envs/babyai/core/roomgrid_level.py:118-143), including the shared
instruction validation (:145-198) and ``check_objs_reachable`` BFS
(:249-301).  The resulting host instruction tree is lowered onto the
batched ``InstrState`` (minigrid_tpu_torch/envs/babyai/core/instr.py) with
a batch of one, via the same descriptor-resolution helpers the generators
use, so verifier behavior — already golden-verified — carries over
unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from minigrid_tpu_torch.compat.parity import (
    HostBuilder,
    HostRoomGrid,
    P_EMPTY,
    pcell,
    _COLOR_NAMES,
)
from minigrid_tpu_torch.core.constants import (
    COLOR_TO_IDX,
    IDX_TO_COLOR,
    OBJ_BALL,
    OBJ_BOX,
    OBJ_DOOR,
    OBJ_KEY,
    OBJ_WALL,
    STATE_OPEN,
)
from minigrid_tpu_torch.envs.babyai.core.instr import (
    LEAF_GOTO,
    LEAF_OPEN,
    LEAF_PICKUP,
    LEAF_PUTNEXT,
    TOP_ACTION,
    TOP_AFTER,
    TOP_AND,
    TOP_BEFORE,
    empty_instr,
    set_desc,
    set_leaf,
    set_top,
    start_carrying_object,
)
from minigrid_tpu_torch.envs.babyai.core.text import encode_babyai_mission

# reference: minigrid/envs/babyai/core/verifier.py:15-21
OBJ_TYPES = ["box", "ball", "key", "door"]
LOC_NAMES = ["left", "right", "front", "behind"]
_TYPE_IDX = {"box": OBJ_BOX, "ball": OBJ_BALL, "key": OBJ_KEY, "door": OBJ_DOOR}
_LEAF = {"goto": LEAF_GOTO, "open": LEAF_OPEN, "pickup": LEAF_PICKUP}
_DIR_VEC = [(1, 0), (0, 1), (-1, 0), (0, -1)]


class RejectSampling(Exception):
    """Host twin of the reference's rejection exception
    (minigrid/envs/babyai/core/roomgrid_level.py:16)."""


@dataclass
class HDesc:
    type: str | None
    color: str | None = None
    loc: str | None = None


@dataclass
class HAction:
    kind: str  # 'goto' | 'open' | 'pickup'
    desc: HDesc
    strict: bool = False


@dataclass
class HPutNext:
    move: HDesc
    fixed: HDesc
    strict: bool = False


@dataclass
class HSeq:
    kind: str  # 'and' | 'before' | 'after'
    a: object
    b: object


# ---------------------------------------------------------------------------
# Host twins of verifier-side queries
# ---------------------------------------------------------------------------


def _room_mask(rg: HostRoomGrid) -> np.ndarray:
    """Cells of the room the agent starts in (reference ``Room.pos_inside``,
    minigrid/core/roomgrid.py:57-63 — includes the border walls)."""
    rs = rg.room_size
    i = rg.agent_pos[0] // (rs - 1)
    j = rg.agent_pos[1] // (rs - 1)
    tx, ty = i * (rs - 1), j * (rs - 1)
    m = np.zeros((rg.width, rg.height), dtype=bool)
    m[tx : tx + rs, ty : ty + rs] = True
    return m


def find_matching(rg: HostRoomGrid, desc: HDesc) -> list[tuple[int, int]]:
    """Positions matching a descriptor (reference ObjDesc.find_matching_objs,
    minigrid/envs/babyai/core/verifier.py:103-169)."""
    room = _room_mask(rg)
    ax, ay = rg.agent_pos
    d1 = _DIR_VEC[rg.agent_dir]
    d2 = (-d1[1], d1[0])
    type_idx = _TYPE_IDX.get(desc.type) if desc.type else None
    color_idx = COLOR_TO_IDX[desc.color] if desc.color else None

    poss = []
    for i in range(rg.width):
        for j in range(rg.height):
            cell = int(rg.grid[i, j])
            if cell == P_EMPTY:
                continue
            if type_idx is not None and (cell & 0xFF) != type_idx:
                continue
            if color_idx is not None and ((cell >> 8) & 0xFF) != color_idx:
                continue
            if desc.loc in LOC_NAMES:
                if not room[i, j]:
                    continue
                v = (i - ax, j - ay)
                dot1 = v[0] * d1[0] + v[1] * d1[1]
                dot2 = v[0] * d2[0] + v[1] * d2[1]
                ok = {
                    "left": dot2 < 0,
                    "right": dot2 > 0,
                    "front": dot1 > 0,
                    "behind": dot1 < 0,
                }[desc.loc]
                if not ok:
                    continue
            poss.append((i, j))
    return poss


def check_objs_reachable(rg: HostRoomGrid, raise_exc: bool = True) -> bool:
    """reference: minigrid/envs/babyai/core/roomgrid_level.py:249-301."""
    reachable = set()
    stack = [tuple(rg.agent_pos)]
    while stack:
        i, j = stack.pop()
        if i < 0 or i >= rg.width or j < 0 or j >= rg.height:
            continue
        if (i, j) in reachable:
            continue
        reachable.add((i, j))
        cell = int(rg.grid[i, j])
        if cell != P_EMPTY and (cell & 0xFF) != OBJ_DOOR:
            continue
        stack.extend([(i + 1, j), (i - 1, j), (i, j + 1), (i, j - 1)])
    for i in range(rg.width):
        for j in range(rg.height):
            cell = int(rg.grid[i, j])
            if cell == P_EMPTY or (cell & 0xFF) == OBJ_WALL:
                continue
            if (i, j) not in reachable:
                if not raise_exc:
                    return False
                raise RejectSampling(f"unreachable object at {(i, j)}")
    return True


def _all_doors(rg: HostRoomGrid) -> list[dict]:
    """Doors in the reference's collection order (per room i-major, slot
    order right/down/left/up; shared doors appear once per adjacent room —
    reference: minigrid/envs/babyai/open.py:60-71)."""
    doors = []
    for i in range(rg.num_cols):
        for j in range(rg.num_rows):
            for k in range(4):
                d = rg.room_doors[(i, j)][k]
                if isinstance(d, dict):
                    doors.append(d)
    return doors


def open_all_doors(rg: HostRoomGrid) -> None:
    """reference: minigrid/envs/babyai/core/roomgrid_level.py:237-247."""
    for d in _all_doors(rg):
        d["locked"] = False
        x, y = d["pos"]
        rg.set(x, y, pcell(OBJ_DOOR, COLOR_TO_IDX[d["color"]], STATE_OPEN))


def validate_instrs(env, rg: HostRoomGrid, instr, unblocking: bool) -> None:
    """reference: minigrid/envs/babyai/core/roomgrid_level.py:145-198."""
    locked_colors = []
    if unblocking:
        for d in _all_doors(rg):
            if d["locked"]:
                locked_colors.append(d["color"])

    def v(ins):
        if isinstance(ins, HPutNext):
            move = find_matching(rg, ins.move)
            fixed = find_matching(rg, ins.fixed)
            if set(move) & set(fixed):
                raise RejectSampling("objects match both sides of PutNext")
            for pa in move:
                for pb in fixed:
                    if abs(pa[0] - pb[0]) + abs(pa[1] - pb[1]) == 1:
                        raise RejectSampling("objs already next to each other")
            if len(move) == 1 and len(fixed) == 1 and move[0] == fixed[0]:
                raise RejectSampling("cannot move an object next to itself")
        elif isinstance(ins, HAction):
            if unblocking and ins.desc.type == "key" and ins.desc.color in locked_colors:
                raise RejectSampling("key matches a locked door color")
        elif isinstance(ins, HSeq):
            v(ins.a)
            v(ins.b)

    v(instr)


def num_navs(instr) -> int:
    """reference: minigrid/envs/babyai/core/roomgrid_level.py:215-235."""
    if isinstance(instr, HPutNext):
        return 2
    if isinstance(instr, HAction):
        return 1
    return num_navs(instr.a) + num_navs(instr.b)


# ---------------------------------------------------------------------------
# Lowering the host instruction tree onto the device InstrState
# ---------------------------------------------------------------------------


def _desc_args(desc: HDesc):
    t = _TYPE_IDX[desc.type] if desc.type else -1
    c = COLOR_TO_IDX[desc.color] if desc.color else -1
    loc = LOC_NAMES.index(desc.loc) if desc.loc else -1
    return t, c, loc


def to_instr_state(rg: HostRoomGrid, instr):
    """The host instruction tree as a batch-of-one ``InstrState``, lowered
    on the CPU through the batched helpers the generators use (the caller
    moves it to its device)."""
    grid = torch.from_numpy(rg.grid[None].astype(np.int32))
    apos = torch.tensor([rg.agent_pos], dtype=torch.int32)
    adir = torch.tensor([rg.agent_dir], dtype=torch.int32)
    room = torch.from_numpy(_room_mask(rg)[None])
    ist = empty_instr(1, rg.width, rg.height, device="cpu")

    def put_leaf(ist, slot, leaf):
        if isinstance(leaf, HPutNext):
            ist = set_leaf(ist, slot, LEAF_PUTNEXT, strict=leaf.strict)
            t, c, loc = _desc_args(leaf.move)
            ist = set_desc(ist, slot, 0, grid, apos, adir, t, c, loc, agent_room_mask=room)
            t, c, loc = _desc_args(leaf.fixed)
            ist = set_desc(ist, slot, 1, grid, apos, adir, t, c, loc, agent_room_mask=room)
        else:
            ist = set_leaf(ist, slot, _LEAF[leaf.kind], strict=leaf.strict)
            t, c, loc = _desc_args(leaf.desc)
            ist = set_desc(ist, slot, 0, grid, apos, adir, t, c, loc, agent_room_mask=room)
        return ist

    def put_side(ist, base_slot, side):
        if isinstance(side, HSeq):
            assert side.kind == "and"
            ist = put_leaf(ist, base_slot, side.a)
            ist = put_leaf(ist, base_slot + 1, side.b)
            return ist, True
        return put_leaf(ist, base_slot, side), False

    if isinstance(instr, HSeq) and instr.kind in ("before", "after"):
        ist, a_and = put_side(ist, 0, instr.a)
        ist, b_and = put_side(ist, 2, instr.b)
        top = TOP_BEFORE if instr.kind == "before" else TOP_AFTER
        ist = set_top(ist, top, a_is_and=a_and, b_is_and=b_and)
    elif isinstance(instr, HSeq):  # and
        ist = put_leaf(ist, 0, instr.a)
        ist = put_leaf(ist, 1, instr.b)
        ist = set_top(ist, TOP_AND)
    else:
        ist = put_leaf(ist, 0, instr)
        ist = set_top(ist, TOP_ACTION)
    return ist


# ---------------------------------------------------------------------------
# Per-family gen_mission mirrors (references cited per function)
# ---------------------------------------------------------------------------


def _recolor(rg: HostRoomGrid, pos, color_name: str):
    cell = int(rg.grid[pos[0], pos[1]])
    rg.grid[pos[0], pos[1]] = (cell & ~0xFF00) | (COLOR_TO_IDX[color_name] << 8)


def _gm_gotoredballgrey(env, rg):
    # reference: goto.py:79-92
    rg.place_agent_room()
    _, _, _ = rg.add_object(0, 0, "ball", "red")
    dists = rg.add_distractors(num_distractors=env.num_dists, all_unique=False)
    for kind, color, pos in dists:
        _recolor(rg, pos, "grey")
    check_objs_reachable(rg)
    return HAction("goto", HDesc("ball", "red"))


def _gm_gotoredball(env, rg):
    # reference: goto.py:142-151
    rg.place_agent_room()
    rg.add_object(0, 0, "ball", "red")
    rg.add_distractors(num_distractors=env.num_dists, all_unique=False)
    check_objs_reachable(rg)
    return HAction("goto", HDesc("ball", "red"))


def _gm_gotoobj(env, rg):
    # reference: goto.py:253-258
    rg.place_agent_room()
    objs = rg.add_distractors(num_distractors=1)
    kind, color, _ = objs[0]
    return HAction("goto", HDesc(kind, color))


def _gm_gotolocal(env, rg):
    # reference: goto.py:332-337
    rg.place_agent_room()
    objs = rg.add_distractors(num_distractors=env.num_dists, all_unique=False)
    check_objs_reachable(rg)
    kind, color, _ = rg.rand_elem(objs)
    return HAction("goto", HDesc(kind, color))


def _gm_goto(env, rg):
    # reference: goto.py:421-432
    rg.place_agent_room()
    rg.connect_all()
    objs = rg.add_distractors(num_distractors=env.num_dists, all_unique=False)
    check_objs_reachable(rg)
    kind, color, _ = rg.rand_elem(objs)
    instr = HAction("goto", HDesc(kind, color))
    if env.doors_open:
        open_all_doors(rg)
    return instr


def _gm_gotoimpunlock(env, rg):
    # reference: goto.py:505-547.  NOTE two reference quirks mirrored here:
    # its `ik is id` / `i is not id` tests compare np.int64 objects by
    # IDENTITY, which is always False / always True — so the key-room loop
    # never re-draws (the key can land in the locked room) and distractors
    # go to every room including the locked one.
    id_ = rg.rand_int(0, rg.num_cols)
    jd = rg.rand_int(0, rg.num_rows)
    door_color, _ = rg.add_door(id_, jd, locked=True)
    ik = rg.rand_int(0, rg.num_cols)
    jk = rg.rand_int(0, rg.num_rows)
    rg.add_object(ik, jk, "key", door_color)
    rg.connect_all()
    for i in range(rg.num_cols):
        for j in range(rg.num_rows):
            rg.add_distractors(i, j, num_distractors=2, all_unique=False)
    while True:
        rg.place_agent_room()
        start = (
            rg.agent_pos[0] // (rg.room_size - 1),
            rg.agent_pos[1] // (rg.room_size - 1),
        )
        if start == (id_, jd):
            continue
        break
    check_objs_reachable(rg)
    (obj,) = rg.add_distractors(id_, jd, num_distractors=1, all_unique=False)
    return HAction("goto", HDesc(obj[0], obj[1]))


def _gm_gotoredblueball(env, rg):
    # reference: goto.py:654-671
    rg.place_agent_room()
    dists = rg.add_distractors(num_distractors=env.num_dists, all_unique=False)
    for kind, color, _ in dists:
        if kind == "ball" and color in ("blue", "red"):
            raise RejectSampling("can only have one blue or red ball")
    color = rg.rand_elem(["red", "blue"])
    rg.add_object(0, 0, "ball", color)
    check_objs_reachable(rg)
    return HAction("goto", HDesc("ball", color))


def _gm_gotodoor(env, rg):
    # reference: goto.py:717-725
    objs = []
    for _ in range(4):
        color, _pos = rg.add_door(1, 1)
        objs.append(color)
    rg.place_agent_room(1, 1)
    color = rg.rand_elem(objs)
    return HAction("goto", HDesc("door", color))


def _gm_gotoobjdoor(env, rg):
    # reference: goto.py:781-792
    rg.place_agent_room(1, 1)
    objs = rg.add_distractors(1, 1, num_distractors=8, all_unique=False)
    entries = [(k, c) for k, c, _ in objs]
    for _ in range(4):
        color, _pos = rg.add_door(1, 1)
        entries.append(("door", color))
    check_objs_reachable(rg)
    kind, color = rg.rand_elem(entries)
    return HAction("goto", HDesc(kind, color))


def _gm_open(env, rg):
    # reference: open.py:60-78
    rg.place_agent_room()
    rg.connect_all()
    rg.add_distractors(num_distractors=18, all_unique=False)
    check_objs_reachable(rg)
    doors = _all_doors(rg)
    door = rg.rand_elem(doors)
    return HAction("open", HDesc("door", door["color"]))


def _gm_openreddoor(env, rg):
    # reference: open.py:126-129
    rg.add_door(0, 0, 0, "red", locked=False)
    rg.place_agent_room(0, 0)
    return HAction("open", HDesc("door", "red"))


def _gm_opendoor(env, rg):
    # reference: open.py:185-205
    door_colors = rg.rand_subset(_COLOR_NAMES, 4)
    for i, color in enumerate(door_colors):
        rg.add_door(1, 1, door_idx=i, color=color, locked=False)
    select_by = env.select_by
    if select_by is None:
        select_by = rg.rand_elem(["color", "loc"])
    if select_by == "color":
        desc = HDesc("door", door_colors[0])
    else:
        desc = HDesc("door", loc=rg.rand_elem(LOC_NAMES))
    rg.place_agent_room(1, 1)
    return HAction("open", desc, strict=env.debug)


def _gm_opentwodoors(env, rg):
    # reference: open.py:264-282
    colors = rg.rand_subset(_COLOR_NAMES, 2)
    first = IDX_TO_COLOR[env.first_color] if env.first_color is not None else colors[0]
    second = (
        IDX_TO_COLOR[env.second_color] if env.second_color is not None else colors[1]
    )
    rg.add_door(1, 1, 2, color=first, locked=False)
    rg.add_door(1, 1, 0, color=second, locked=False)
    rg.place_agent_room(1, 1)
    return HSeq(
        "before",
        HAction("open", HDesc("door", first), strict=env.strict),
        HAction("open", HDesc("door", second)),
    )


def _gm_opendoorsorder(env, rg):
    # reference: open.py:339-363
    colors = rg.rand_subset(_COLOR_NAMES, env.num_doors)
    doors = []
    for i in range(env.num_doors):
        color, pos = rg.add_door(1, 1, color=colors[i], locked=False)
        doors.append((color, pos))
    rg.place_agent_room(1, 1)
    d1, d2 = rg.rand_subset(doors, 2)
    desc1, desc2 = HDesc("door", d1[0]), HDesc("door", d2[0])
    mode = rg.rand_int(0, 3)
    if mode == 0:
        return HAction("open", desc1, strict=env.debug)
    if mode == 1:
        return HSeq(
            "before",
            HAction("open", desc1, strict=env.debug),
            HAction("open", desc2, strict=env.debug),
        )
    return HSeq(
        "after",
        HAction("open", desc1, strict=env.debug),
        HAction("open", desc2, strict=env.debug),
    )


def _gm_pickup(env, rg):
    # reference: pickup.py:64-71
    rg.place_agent_room()
    rg.connect_all()
    objs = rg.add_distractors(num_distractors=18, all_unique=False)
    check_objs_reachable(rg)
    kind, color, _ = rg.rand_elem(objs)
    return HAction("pickup", HDesc(kind, color))


def _gm_unblockpickup(env, rg):
    # reference: pickup.py:127-140
    rg.place_agent_room()
    rg.connect_all()
    objs = rg.add_distractors(num_distractors=20, all_unique=False)
    if check_objs_reachable(rg, raise_exc=False):
        raise RejectSampling("all objects reachable")
    kind, color, _ = rg.rand_elem(objs)
    return HAction("pickup", HDesc(kind, color))


def _gm_pickupdist(env, rg):
    # reference: pickup.py:275-290
    objs = rg.add_distractors(num_distractors=5)
    rg.place_agent_room(0, 0)
    kind, color, _ = rg.rand_elem(objs)
    select_by = rg.rand_elem(["type", "color", "both"])
    if select_by == "color":
        kind = None
    elif select_by == "type":
        color = None
    return HAction("pickup", HDesc(kind, color), strict=env.debug)


def _gm_pickupabove(env, rg):
    # reference: pickup.py:353-362
    kind, color, _ = rg.add_object(1, 0)
    rg.add_door(1, 1, 3, locked=False)
    rg.place_agent_room(1, 1)
    rg.connect_all()
    return HAction("pickup", HDesc(kind, color))


def _gm_putnextlocal(env, rg):
    # reference: putnext.py:61-69
    rg.place_agent_room()
    objs = rg.add_distractors(num_distractors=env.num_objs, all_unique=True)
    check_objs_reachable(rg)
    o1, o2 = rg.rand_subset(objs, 2)
    return HPutNext(HDesc(o1[0], o1[1]), HDesc(o2[0], o2[1]))


def _gm_putnext(env, rg):
    # reference: putnext.py:166-190
    rg.place_agent_room(0, 0)
    objs_l = rg.add_distractors(0, 0, env.objs_per_room)
    objs_r = rg.add_distractors(1, 0, env.objs_per_room)
    rg.remove_wall(0, 0, 0)
    a = rg.rand_elem(objs_l)
    b = rg.rand_elem(objs_r)
    if rg.rand_bool():
        a, b = b, a
    instr = HPutNext(HDesc(a[0], a[1]), HDesc(b[0], b[1]))
    instr.obj_a_pos = a[2]
    return instr


def _gm_unlock_babyai(env, rg):
    # reference: unlock.py:76-120.  Same np.int64 `is` quirks as
    # GoToImpUnlock: the key-room loop never re-draws, distractors go to
    # every room.  The color filter uses string identity, which DOES work.
    id_ = rg.rand_int(0, rg.num_cols)
    jd = rg.rand_int(0, rg.num_rows)
    door_color, _ = rg.add_door(id_, jd, locked=True)
    ik = rg.rand_int(0, rg.num_cols)
    jk = rg.rand_int(0, rg.num_rows)
    rg.add_object(ik, jk, "key", door_color)
    if rg.rand_bool():
        rg.connect_all(door_colors=[c for c in _COLOR_NAMES if c != door_color])
    else:
        rg.connect_all()
    for i in range(rg.num_cols):
        for j in range(rg.num_rows):
            rg.add_distractors(i, j, num_distractors=3, all_unique=False)
    while True:
        rg.place_agent_room()
        start = (
            rg.agent_pos[0] // (rg.room_size - 1),
            rg.agent_pos[1] // (rg.room_size - 1),
        )
        if start == (id_, jd):
            continue
        break
    check_objs_reachable(rg)
    return HAction("open", HDesc("door", door_color))


def _gm_unlocklocal(env, rg):
    # reference: unlock.py:161-169
    door_color, _ = rg.add_door(1, 1, locked=True)
    rg.add_object(1, 1, "key", door_color)
    if env.distractors:
        rg.add_distractors(1, 1, num_distractors=3)
    rg.place_agent_room(1, 1)
    return HAction("open", HDesc("door"))


def _gm_keyinbox(env, rg):
    # reference: unlock.py:219-229 — the key hides in the box's contains
    # plane; the box color is a fresh draw.
    door_color, _ = rg.add_door(1, 1, locked=True)
    box_color = rg.rand_color()
    key_packed = pcell(OBJ_KEY, COLOR_TO_IDX[door_color])
    rg.place_in_room(
        1, 1, pcell(OBJ_BOX, box_color), ("box", IDX_TO_COLOR[box_color]),
        contains=key_packed & 0xFFFF,
    )
    rg.place_agent_room(1, 1)
    return HAction("open", HDesc("door"))


def _gm_unlockpickup_babyai(env, rg):
    # reference: unlock.py:288-300
    kind, color, _ = rg.add_object(1, 0, kind="box")
    door_color, _ = rg.add_door(0, 0, 0, locked=True)
    rg.add_object(0, 0, "key", door_color)
    if env.distractors:
        rg.add_distractors(num_distractors=4)
    rg.place_agent_room(0, 0)
    return HAction("pickup", HDesc(kind, color))


def _gm_blockedunlockpickup_babyai(env, rg):
    # reference: unlock.py:365-379 — instruction names the type only
    kind, _, _ = rg.add_object(1, 0, kind="box")
    _, pos = rg.add_door(0, 0, 0, locked=True)
    ball_color = rg.rand_color()
    rg.set(pos[0] - 1, pos[1], pcell(OBJ_BALL, ball_color))
    door_color = None  # key color == door color, drawn inside add_door
    # re-read the door record for its color
    door = rg.room_doors[(0, 0)][0]
    rg.add_object(0, 0, "key", door["color"])
    rg.place_agent_room(0, 0)
    return HAction("pickup", HDesc(kind))


def _gm_unlocktounlock(env, rg):
    # reference: unlock.py:438-457
    colors = rg.rand_subset(_COLOR_NAMES, 2)
    rg.add_door(0, 0, door_idx=0, color=colors[0], locked=True)
    rg.add_object(2, 0, kind="key", color=colors[0])
    rg.add_door(1, 0, door_idx=0, color=colors[1], locked=True)
    rg.add_object(1, 0, kind="key", color=colors[1])
    kind, _, _ = rg.add_object(0, 0, kind="ball")
    rg.place_agent_room(1, 0)
    return HAction("pickup", HDesc(kind))


def _gm_actionobjdoor(env, rg):
    # reference: other.py:79-99
    objs = [(k, c) for k, c, _ in rg.add_distractors(1, 1, num_distractors=5)]
    for _ in range(4):
        color, _ = rg.add_door(1, 1, locked=False)
        objs.append(("door", color))
    rg.place_agent_room(1, 1)
    kind, color = rg.rand_elem(objs)
    desc = HDesc(kind, color)
    if kind == "door":
        return HAction("goto" if rg.rand_bool() else "open", desc)
    return HAction("goto" if rg.rand_bool() else "pickup", desc)


def _gm_findobj(env, rg):
    # reference: other.py:152-160 — NOTE the reference draws (i, j) with the
    # bounds swapped (i from num_rows, j from num_cols); mirrored as-is.
    i = rg.rand_int(0, rg.num_rows)
    j = rg.rand_int(0, rg.num_cols)
    kind, _, _ = rg.add_object(i, j)
    rg.place_agent_room(1, 1)
    rg.connect_all()
    return HAction("pickup", HDesc(kind))


def _gm_keycorridor_babyai(env, rg):
    # reference: other.py:240-260 — instruction names the type only
    for j in range(1, rg.num_rows):
        rg.remove_wall(1, j, 3)
    room_idx = rg.rand_int(0, rg.num_rows)
    door_color, _ = rg.add_door(2, room_idx, 2, locked=True)
    kind = {OBJ_BALL: "ball", OBJ_KEY: "key", OBJ_BOX: "box"}[env.obj_kind]
    rg.add_object(2, room_idx, kind=kind)
    rg.add_object(0, rg.rand_int(0, rg.num_rows), "key", door_color)
    rg.place_agent_room(1, rg.num_rows // 2)
    rg.connect_all()
    return HAction("pickup", HDesc(kind))


def _gm_oneroom(env, rg):
    # reference: other.py:316-320
    kind, _, _ = rg.add_object(0, 0, kind="ball")
    rg.place_agent_room()
    return HAction("pickup", HDesc(kind))


def _gm_movetwoacross(env, rg):
    # reference: other.py:396-424
    rg.place_agent_room(0, 0)
    objs_l = rg.add_distractors(0, 0, env.objs_per_room)
    objs_r = rg.add_distractors(1, 0, env.objs_per_room)
    rg.remove_wall(0, 0, 0)
    objs_l = rg.rand_subset(objs_l, 2)
    objs_r = rg.rand_subset(objs_r, 2)
    a, d = objs_l[0], objs_l[1]
    b, c = objs_r[0], objs_r[1]
    return HSeq(
        "before",
        HPutNext(HDesc(a[0], a[1]), HDesc(b[0], b[1])),
        HPutNext(HDesc(c[0], c[1]), HDesc(d[0], d[1])),
    )


OBJ_TYPES_NOT_DOOR = [t for t in OBJ_TYPES if t != "door"]


def _room_of(rg, pos):
    return (pos[0] // (rg.room_size - 1), pos[1] // (rg.room_size - 1))


def _pos_inside_room(rg, room, pos):
    rs = rg.room_size
    tx, ty = room[0] * (rs - 1), room[1] * (rs - 1)
    return tx <= pos[0] < tx + rs and ty <= pos[1] < ty + rs


def _lg_add_locked_room(env, rg):
    # reference: levelgen.py:85-112
    while True:
        i = rg.rand_int(0, rg.num_cols)
        j = rg.rand_int(0, rg.num_rows)
        door_idx = rg.rand_int(0, 4)
        locked_room = (i, j)
        if rg.neighbor(i, j, door_idx) is None:
            continue
        door_color, _ = rg.add_door(i, j, door_idx, locked=True)
        break
    while True:
        i = rg.rand_int(0, rg.num_cols)
        j = rg.rand_int(0, rg.num_rows)
        if (i, j) == locked_room:
            continue
        rg.add_object(i, j, "key", door_color)
        break
    return locked_room


def _lg_rand_obj(env, rg, locked_room, types=OBJ_TYPES, max_tries=100):
    # reference: levelgen.py:114-156
    num_tries = 0
    while True:
        if num_tries > max_tries:
            raise RecursionError("failed to find suitable object")
        num_tries += 1
        color = rg.rand_elem([None, *_COLOR_NAMES])
        type_ = rg.rand_elem(types)
        loc = None
        if env.locations and rg.rand_bool():
            loc = rg.rand_elem(LOC_NAMES)
        desc = HDesc(type_, color, loc)
        poss = find_matching(rg, desc)
        if len(poss) == 0:
            continue
        if not env.implicit_unlock and locked_room is not None:
            not_locked = [p for p in poss if not _pos_inside_room(rg, locked_room, p)]
            if len(not_locked) == 0:
                continue
        return desc


def _lg_rand_instr(env, rg, locked_room, action_kinds, instr_kinds, depth=0):
    # reference: levelgen.py:158-210
    kind = rg.rand_elem(instr_kinds)
    if kind == "action":
        action = rg.rand_elem(action_kinds)
        if action == "goto":
            return HAction("goto", _lg_rand_obj(env, rg, locked_room))
        if action == "pickup":
            return HAction(
                "pickup", _lg_rand_obj(env, rg, locked_room, types=OBJ_TYPES_NOT_DOOR)
            )
        if action == "open":
            return HAction("open", _lg_rand_obj(env, rg, locked_room, types=["door"]))
        return HPutNext(
            _lg_rand_obj(env, rg, locked_room, types=OBJ_TYPES_NOT_DOOR),
            _lg_rand_obj(env, rg, locked_room),
        )
    if kind == "and":
        a = _lg_rand_instr(env, rg, locked_room, action_kinds, ["action"], depth + 1)
        b = _lg_rand_instr(env, rg, locked_room, action_kinds, ["action"], depth + 1)
        return HSeq("and", a, b)
    # seq
    a = _lg_rand_instr(env, rg, locked_room, action_kinds, ["action", "and"], depth + 1)
    b = _lg_rand_instr(env, rg, locked_room, action_kinds, ["action", "and"], depth + 1)
    return HSeq(rg.rand_elem(["before", "after"]), a, b)


def _gm_levelgen(env, rg):
    # reference: levelgen.py:58-83.  NOTE ``self.locked_room`` is STICKY in
    # the reference — it is never cleared between generation attempts or
    # resets, so the ``rand_obj`` implicit-unlock position filter can act on
    # a stale room from an earlier attempt/episode, while the agent-placement
    # identity check (`start_room is self.locked_room`) only ever matches a
    # room added in THIS attempt.  Both behaviors are mirrored.
    fresh_locked = None
    if float(rg.rng.uniform(0, 1)) < env.locked_room_prob:
        fresh_locked = _lg_add_locked_room(env, rg)
        env._parity_locked_room = fresh_locked
    sticky_locked = getattr(env, "_parity_locked_room", None)
    rg.connect_all()
    rg.add_distractors(num_distractors=env.num_dists, all_unique=False)
    while True:
        rg.place_agent_room()
        if fresh_locked is not None and _room_of(rg, rg.agent_pos) == fresh_locked:
            continue
        break
    if not env.unblocking:
        check_objs_reachable(rg)
    return _lg_rand_instr(
        env, rg, sticky_locked, list(env.action_kinds), list(env.instr_kinds)
    )


BABYAI_GEN_MISSION = {
    "GoToRedBallGrey": _gm_gotoredballgrey,
    "GoToRedBall": _gm_gotoredball,
    "GoToObj": _gm_gotoobj,
    "GoToLocal": _gm_gotolocal,
    "GoTo": _gm_goto,
    "GoToImpUnlock": _gm_gotoimpunlock,
    "GoToRedBlueBall": _gm_gotoredblueball,
    "GoToDoor": _gm_gotodoor,
    "GoToObjDoor": _gm_gotoobjdoor,
    "Open": _gm_open,
    "OpenRedDoor": _gm_openreddoor,
    "OpenDoor": _gm_opendoor,
    "OpenTwoDoors": _gm_opentwodoors,
    "OpenDoorsOrder": _gm_opendoorsorder,
    "Pickup": _gm_pickup,
    "UnblockPickup": _gm_unblockpickup,
    "PickupDist": _gm_pickupdist,
    "PickupAbove": _gm_pickupabove,
    "PutNextLocal": _gm_putnextlocal,
    "PutNext": _gm_putnext,
    "Unlock": _gm_unlock_babyai,
    "UnlockLocal": _gm_unlocklocal,
    "KeyInBox": _gm_keyinbox,
    "UnlockPickup": _gm_unlockpickup_babyai,
    "BlockedUnlockPickup": _gm_blockedunlockpickup_babyai,
    "UnlockToUnlock": _gm_unlocktounlock,
    "ActionObjDoor": _gm_actionobjdoor,
    "FindObjS5": _gm_findobj,
    "KeyCorridor": _gm_keycorridor_babyai,
    "OneRoomS8": _gm_oneroom,
    "MoveTwoAcross": _gm_movetwoacross,
    "LevelGen": _gm_levelgen,
}

# Families whose reference class carries an ``unblocking`` attribute (only
# LevelGen-derived levels do — reference levelgen.py:47); the RoomGridLevel
# families above do not, so the key/locked-door validation is skipped for
# them (reference roomgrid_level.py:178-190 checks hasattr).
UNBLOCKING_FAMILIES: set[str] = {"LevelGen"}


def babyai_parity_gen(env, b: HostBuilder):
    """Parity generator for BabyAI levels, registered in
    parity.PARITY_GENERATORS via make_babyai_generators()."""
    gen_mission = None
    for klass in type(env).__mro__:
        gen_mission = BABYAI_GEN_MISSION.get(klass.__name__)
        if gen_mission is not None:
            break
    if gen_mission is None:
        raise NotImplementedError(type(env).__name__)

    eb = env.builder
    unblocking = any(
        k.__name__ in UNBLOCKING_FAMILIES for k in type(env).__mro__
    ) and getattr(env, "unblocking", False)

    # reference roomgrid_level.py:118-143: regenerate the whole RoomGrid on
    # RecursionError / RejectSampling.
    while True:
        rg = HostRoomGrid(eb.room_size, eb.num_rows, eb.num_cols, b.rng)
        try:
            instr = gen_mission(env, rg)
            validate_instrs(env, rg, instr, unblocking)
        except (RecursionError, RejectSampling):
            continue
        break

    ist = to_instr_state(rg, instr)

    out = {}
    if getattr(env, "start_carrying", False):
        # reference putnext.py:192-200: lift the move object after the
        # verifier has resolved it against the in-grid layout.
        pos = instr.obj_a_pos
        ist = start_carrying_object(ist, torch.tensor([pos], dtype=torch.int32))
        rg.set(pos[0], pos[1], None)
        t, c, _ = _desc_args(instr.move)
        out["carrying"] = t | (c << 8)

    if env.fixed_max_steps:
        max_steps = env.max_steps
    else:
        nav_time_maze = eb.room_size**2 * eb.num_rows * eb.num_cols
        max_steps = num_navs(instr) * nav_time_maze

    b.grid = rg.grid
    b.contains = rg.contains
    b.agent_pos = rg.agent_pos
    b.agent_dir = rg.agent_dir
    out.update(
        {
            "extra": {"instr": ist},
            "mission": encode_babyai_mission(ist)[0].numpy(),
            "max_steps": max_steps,
            "complete": True,
        }
    )
    return out
