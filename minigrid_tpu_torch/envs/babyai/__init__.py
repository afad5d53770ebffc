"""BabyAI levels; importing this package registers their 96 ids with the JAX
package's kwargs (``minigrid_tpu/envs/babyai/__init__.py:61-171``;
reference registration table: minigrid/__init__.py:576-1135).  With the
classic families and WFC's six (``envs/wfc``) the port holds every id of the
JAX package's registry, 177 in all."""

from __future__ import annotations

from minigrid_tpu_torch.envs.babyai.goto import (
    GoTo,
    GoToDoor,
    GoToImpUnlock,
    GoToLocal,
    GoToObj,
    GoToObjDoor,
    GoToRedBall,
    GoToRedBallGrey,
    GoToRedBallNoDists,
    GoToRedBlueBall,
)
from minigrid_tpu_torch.envs.babyai.levelgen import (
    BossLevel,
    BossLevelNoUnlock,
    GoToSeq,
    LevelGen,
    MiniBossLevel,
    PickupLoc,
    Synth,
    SynthLoc,
    SynthSeq,
)
from minigrid_tpu_torch.envs.babyai.open import Open, OpenDoor, OpenDoorsOrder, OpenRedDoor, OpenTwoDoors
from minigrid_tpu_torch.envs.babyai.other import ActionObjDoor, FindObjS5, KeyCorridor, MoveTwoAcross, OneRoomS8
from minigrid_tpu_torch.envs.babyai.pickup import Pickup, PickupAbove, PickupDist, UnblockPickup
from minigrid_tpu_torch.envs.babyai.putnext import PutNext, PutNextLocal
from minigrid_tpu_torch.envs.babyai.unlock import (
    BlockedUnlockPickup,
    KeyInBox,
    Unlock,
    UnlockLocal,
    UnlockPickup,
    UnlockToUnlock,
)
from minigrid_tpu_torch.registry import register

# -- GoTo --
register("BabyAI-GoToRedBallGrey-v0", GoToRedBallGrey)
register("BabyAI-GoToRedBall-v0", GoToRedBall)
register("BabyAI-GoToRedBallNoDists-v0", GoToRedBallNoDists)
register("BabyAI-GoToObj-v0", GoToObj)
register("BabyAI-GoToObjS4-v0", GoToObj, room_size=4)
register("BabyAI-GoToObjS6-v1", GoToObj, room_size=6)
register("BabyAI-GoToLocal-v0", GoToLocal)
for _size, _dists in ((5, 2), (6, 2), (6, 3), (6, 4), (7, 4), (7, 5), (8, 2), (8, 3), (8, 4), (8, 5), (8, 6), (8, 7)):
    register(f"BabyAI-GoToLocalS{_size}N{_dists}-v0", GoToLocal, room_size=_size, num_dists=_dists)
register("BabyAI-GoTo-v0", GoTo)
register("BabyAI-GoToOpen-v0", GoTo, doors_open=True)
register("BabyAI-GoToObjMaze-v0", GoTo, num_dists=1, doors_open=False)
register("BabyAI-GoToObjMazeOpen-v0", GoTo, num_dists=1, doors_open=True)
register("BabyAI-GoToObjMazeS4R2-v0", GoTo, num_dists=1, room_size=4, num_rows=2, num_cols=2)
for _size in (4, 5, 6, 7):
    register(f"BabyAI-GoToObjMazeS{_size}-v0", GoTo, num_dists=1, room_size=_size)
register("BabyAI-GoToImpUnlock-v0", GoToImpUnlock)
register("BabyAI-GoToSeq-v0", GoToSeq)
register("BabyAI-GoToSeqS5R2-v0", GoToSeq, room_size=5, num_rows=2, num_cols=2, num_dists=4)
register("BabyAI-GoToRedBlueBall-v0", GoToRedBlueBall)
register("BabyAI-GoToDoor-v0", GoToDoor)
register("BabyAI-GoToObjDoor-v0", GoToObjDoor)

# -- Open --
register("BabyAI-Open-v0", Open)
register("BabyAI-OpenRedDoor-v0", OpenRedDoor)
register("BabyAI-OpenDoor-v0", OpenDoor)
register("BabyAI-OpenDoorDebug-v0", OpenDoor, debug=True, select_by=None)
register("BabyAI-OpenDoorColor-v0", OpenDoor, select_by="color")
register("BabyAI-OpenDoorLoc-v0", OpenDoor, select_by="loc")
register("BabyAI-OpenTwoDoors-v0", OpenTwoDoors)
register("BabyAI-OpenRedBlueDoors-v0", OpenTwoDoors, first_color="red", second_color="blue")
register("BabyAI-OpenRedBlueDoorsDebug-v0", OpenTwoDoors, first_color="red", second_color="blue", strict=True)
for _doors in (2, 4):
    register(f"BabyAI-OpenDoorsOrderN{_doors}-v0", OpenDoorsOrder, num_doors=_doors)
    register(f"BabyAI-OpenDoorsOrderN{_doors}Debug-v0", OpenDoorsOrder, debug=True, num_doors=_doors)

# -- Pickup --
register("BabyAI-Pickup-v0", Pickup)
register("BabyAI-UnblockPickup-v0", UnblockPickup)
register("BabyAI-PickupLoc-v0", PickupLoc)
register("BabyAI-PickupDist-v0", PickupDist)
register("BabyAI-PickupDistDebug-v0", PickupDist, debug=True)
register("BabyAI-PickupAbove-v0", PickupAbove)

# -- PutNext --
register("BabyAI-PutNextLocal-v0", PutNextLocal)
register("BabyAI-PutNextLocalS5N3-v0", PutNextLocal, room_size=5, num_objs=3)
register("BabyAI-PutNextLocalS6N4-v0", PutNextLocal, room_size=6, num_objs=4)
for _size, _objs in ((4, 1), (5, 2), (5, 1), (6, 3), (7, 4)):
    register(f"BabyAI-PutNextS{_size}N{_objs}-v0", PutNext, room_size=_size, objs_per_room=_objs)
for _size, _objs in ((5, 2), (6, 3), (7, 4)):
    register(f"BabyAI-PutNextS{_size}N{_objs}Carrying-v0", PutNext, room_size=_size, objs_per_room=_objs, start_carrying=True)

# -- Unlock --
register("BabyAI-Unlock-v0", Unlock)
register("BabyAI-UnlockLocal-v0", UnlockLocal)
register("BabyAI-UnlockLocalDist-v0", UnlockLocal, distractors=True)
register("BabyAI-KeyInBox-v0", KeyInBox)
register("BabyAI-UnlockPickup-v0", UnlockPickup)
register("BabyAI-UnlockPickupDist-v0", UnlockPickup, distractors=True)
register("BabyAI-BlockedUnlockPickup-v0", BlockedUnlockPickup)
register("BabyAI-UnlockToUnlock-v0", UnlockToUnlock)

# -- Other --
register("BabyAI-ActionObjDoor-v0", ActionObjDoor)
register("BabyAI-FindObjS5-v0", FindObjS5)
register("BabyAI-FindObjS6-v0", FindObjS5, room_size=6)
register("BabyAI-FindObjS7-v0", FindObjS5, room_size=7)
register("BabyAI-KeyCorridor-v0", KeyCorridor)
register("BabyAI-KeyCorridorS3R1-v0", KeyCorridor, room_size=3, num_rows=1)
for _size, _rows in ((3, 2), (3, 3), (4, 3), (5, 3), (6, 3)):
    register(f"BabyAI-KeyCorridorS{_size}R{_rows}-v0", KeyCorridor, room_size=_size, num_rows=_rows)
register("BabyAI-OneRoomS8-v0", OneRoomS8)
for _size in (12, 16, 20):
    register(f"BabyAI-OneRoomS{_size}-v0", OneRoomS8, room_size=_size)
register("BabyAI-MoveTwoAcrossS5N2-v0", MoveTwoAcross, room_size=5, objs_per_room=2)
register("BabyAI-MoveTwoAcrossS8N9-v0", MoveTwoAcross, room_size=8, objs_per_room=9)

# -- Synth --
register("BabyAI-Synth-v0", Synth)
register("BabyAI-SynthS5R2-v0", Synth, room_size=5, num_rows=2)
register("BabyAI-SynthLoc-v0", SynthLoc)
register("BabyAI-SynthSeq-v0", SynthSeq)
register("BabyAI-MiniBossLevel-v0", MiniBossLevel)
register("BabyAI-BossLevel-v0", BossLevel)
register("BabyAI-BossLevelNoUnlock-v0", BossLevelNoUnlock)

__all__ = ["LevelGen"]
