"""BabyAI levels; importing this package registers their ids with the JAX
package's kwargs (``minigrid_tpu/envs/babyai/__init__.py:60-94``; reference
registration table: minigrid/__init__.py:576-1135).  Only the GoTo group of
``goto.py`` is here: GoToSeq and GoToSeqS5R2 come with ``levelgen.py``
(ROADMAP.md queue 1)."""

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
from minigrid_tpu_torch.registry import register

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
register("BabyAI-GoToRedBlueBall-v0", GoToRedBlueBall)
register("BabyAI-GoToDoor-v0", GoToDoor)
register("BabyAI-GoToObjDoor-v0", GoToObjDoor)
