"""Environment families; importing this package registers their ids, with
the JAX package's kwargs (``minigrid_tpu/envs/__init__.py:38-197``;
reference registration table: minigrid/__init__.py:24-569)."""

from __future__ import annotations

from minigrid_tpu_torch.envs import babyai as _babyai  # noqa: F401  (registers the BabyAI ids)
from minigrid_tpu_torch.envs.crossing import CrossingEnv
from minigrid_tpu_torch.envs.distshift import DistShiftEnv
from minigrid_tpu_torch.envs.doorkey import DoorKeyEnv
from minigrid_tpu_torch.envs.dynamicobstacles import DynamicObstaclesEnv
from minigrid_tpu_torch.envs.empty import EmptyEnv
from minigrid_tpu_torch.envs.fetch import FetchEnv
from minigrid_tpu_torch.envs.fourrooms import FourRoomsEnv
from minigrid_tpu_torch.envs.gotodoor import GoToDoorEnv
from minigrid_tpu_torch.envs.gotoobject import GoToObjectEnv
from minigrid_tpu_torch.envs.keycorridor import KeyCorridorEnv
from minigrid_tpu_torch.envs.lavagap import LavaGapEnv
from minigrid_tpu_torch.envs.lockedroom import LockedRoomEnv
from minigrid_tpu_torch.envs.memory import MemoryEnv
from minigrid_tpu_torch.envs.multiroom import MultiRoomEnv
from minigrid_tpu_torch.envs.obstructedmaze import (
    ObstructedMaze_1Dlhb,
    ObstructedMaze_Full,
    ObstructedMaze_Full_V1,
    ObstructedMazeEnv,
)
from minigrid_tpu_torch.envs.playground import PlaygroundEnv
from minigrid_tpu_torch.envs.putnear import PutNearEnv
from minigrid_tpu_torch.envs.redbluedoors import RedBlueDoorEnv
from minigrid_tpu_torch.envs.unlock import BlockedUnlockPickupEnv, UnlockEnv, UnlockPickupEnv
from minigrid_tpu_torch.envs.wfc import WFC_PRESETS, WFCEnv
from minigrid_tpu_torch.registry import register

# -- Empty --
register("MiniGrid-Empty-5x5-v0", EmptyEnv, size=5)
register("MiniGrid-Empty-Random-5x5-v0", EmptyEnv, size=5, agent_start_pos=None)
register("MiniGrid-Empty-6x6-v0", EmptyEnv, size=6)
register("MiniGrid-Empty-Random-6x6-v0", EmptyEnv, size=6, agent_start_pos=None)
register("MiniGrid-Empty-8x8-v0", EmptyEnv)
register("MiniGrid-Empty-16x16-v0", EmptyEnv, size=16)

# -- DoorKey --
for _size in (5, 6, 8, 16):
    register(f"MiniGrid-DoorKey-{_size}x{_size}-v0", DoorKeyEnv, size=_size)

# -- FourRooms --
register("MiniGrid-FourRooms-v0", FourRoomsEnv)

# -- Crossings --
for _size, _n in ((9, 1), (9, 2), (9, 3), (11, 5)):
    register(f"MiniGrid-LavaCrossingS{_size}N{_n}-v0", CrossingEnv, size=_size, num_crossings=_n)
    register(
        f"MiniGrid-SimpleCrossingS{_size}N{_n}-v0",
        CrossingEnv, size=_size, num_crossings=_n, obstacle_type="wall",
    )

# -- Dynamic-Obstacles --
register("MiniGrid-Dynamic-Obstacles-5x5-v0", DynamicObstaclesEnv, size=5, n_obstacles=2)
register(
    "MiniGrid-Dynamic-Obstacles-Random-5x5-v0",
    DynamicObstaclesEnv, size=5, agent_start_pos=None, n_obstacles=2,
)
register("MiniGrid-Dynamic-Obstacles-6x6-v0", DynamicObstaclesEnv, size=6, n_obstacles=3)
register(
    "MiniGrid-Dynamic-Obstacles-Random-6x6-v0",
    DynamicObstaclesEnv, size=6, agent_start_pos=None, n_obstacles=3,
)
register("MiniGrid-Dynamic-Obstacles-8x8-v0", DynamicObstaclesEnv)
register("MiniGrid-Dynamic-Obstacles-16x16-v0", DynamicObstaclesEnv, size=16, n_obstacles=8)

# -- Fetch --
register("MiniGrid-Fetch-5x5-N2-v0", FetchEnv, size=5, numObjs=2)
register("MiniGrid-Fetch-6x6-N2-v0", FetchEnv, size=6, numObjs=2)
register("MiniGrid-Fetch-8x8-N3-v0", FetchEnv)

# -- GoToDoor --
register("MiniGrid-GoToDoor-5x5-v0", GoToDoorEnv)
register("MiniGrid-GoToDoor-6x6-v0", GoToDoorEnv, size=6)
register("MiniGrid-GoToDoor-8x8-v0", GoToDoorEnv, size=8)

# -- GoToObject --
register("MiniGrid-GoToObject-6x6-N2-v0", GoToObjectEnv)
register("MiniGrid-GoToObject-8x8-N2-v0", GoToObjectEnv, size=8, numObjs=2)

# -- DistShift --
register("MiniGrid-DistShift1-v0", DistShiftEnv, strip2_row=2)
register("MiniGrid-DistShift2-v0", DistShiftEnv, strip2_row=5)

# -- LavaGap --
for _size in (5, 6, 7):
    register(f"MiniGrid-LavaGapS{_size}-v0", LavaGapEnv, size=_size)

# -- Memory --
register("MiniGrid-MemoryS17Random-v0", MemoryEnv, size=17, random_length=True)
register("MiniGrid-MemoryS13Random-v0", MemoryEnv, size=13, random_length=True)
for _size in (13, 11, 9, 7):
    register(f"MiniGrid-MemoryS{_size}-v0", MemoryEnv, size=_size)

# -- KeyCorridor --
for _room_size, _rows in ((3, 1), (3, 2), (3, 3), (4, 3), (5, 3), (6, 3)):
    register(f"MiniGrid-KeyCorridorS{_room_size}R{_rows}-v0", KeyCorridorEnv, room_size=_room_size, num_rows=_rows)

# -- LockedRoom --
register("MiniGrid-LockedRoom-v0", LockedRoomEnv)

# -- MultiRoom (the JAX package's kwargs) --
register("MiniGrid-MultiRoom-N2-S4-v0", MultiRoomEnv, minNumRooms=2, maxNumRooms=2, maxRoomSize=4)
register("MiniGrid-MultiRoom-N4-S5-v0", MultiRoomEnv, minNumRooms=6, maxNumRooms=6, maxRoomSize=5)
register("MiniGrid-MultiRoom-N6-v0", MultiRoomEnv, minNumRooms=6, maxNumRooms=6)

# -- ObstructedMaze v0 and v1 --
register("MiniGrid-ObstructedMaze-1Dl-v0", ObstructedMaze_1Dlhb, key_in_box=False, blocked=False)
register("MiniGrid-ObstructedMaze-1Dlh-v0", ObstructedMaze_1Dlhb, key_in_box=True, blocked=False)
register("MiniGrid-ObstructedMaze-1Dlhb-v0", ObstructedMaze_1Dlhb)
_QUARTER = dict(agent_room=(2, 1), num_quarters=1, num_rooms_visited=4)
register("MiniGrid-ObstructedMaze-2Dl-v0", ObstructedMaze_Full, key_in_box=False, blocked=False, **_QUARTER)
register("MiniGrid-ObstructedMaze-2Dlh-v0", ObstructedMaze_Full, key_in_box=True, blocked=False, **_QUARTER)
for _version, _cls in (("v0", ObstructedMaze_Full), ("v1", ObstructedMaze_Full_V1)):
    register(f"MiniGrid-ObstructedMaze-2Dlhb-{_version}", _cls, key_in_box=True, blocked=True, **_QUARTER)
    register(
        f"MiniGrid-ObstructedMaze-1Q-{_version}", _cls,
        agent_room=(1, 1), key_in_box=True, blocked=True, num_quarters=1, num_rooms_visited=5,
    )
    register(
        f"MiniGrid-ObstructedMaze-2Q-{_version}", _cls,
        agent_room=(2, 1), key_in_box=True, blocked=True, num_quarters=2, num_rooms_visited=11,
    )
    register(f"MiniGrid-ObstructedMaze-Full-{_version}", _cls)

# -- Playground --
register("MiniGrid-Playground-v0", PlaygroundEnv)

# -- Unlock --
register("MiniGrid-Unlock-v0", UnlockEnv)
register("MiniGrid-UnlockPickup-v0", UnlockPickupEnv)
register("MiniGrid-BlockedUnlockPickup-v0", BlockedUnlockPickupEnv)

# -- PutNear --
register("MiniGrid-PutNear-6x6-N2-v0", PutNearEnv)
register("MiniGrid-PutNear-8x8-N3-v0", PutNearEnv, size=8, numObjs=3)

# -- RedBlueDoors --
register("MiniGrid-RedBlueDoors-6x6-v0", RedBlueDoorEnv, size=6)
register("MiniGrid-RedBlueDoors-8x8-v0", RedBlueDoorEnv)

__all__ = [
    "BlockedUnlockPickupEnv",
    "CrossingEnv",
    "DistShiftEnv",
    "DoorKeyEnv",
    "DynamicObstaclesEnv",
    "EmptyEnv",
    "FetchEnv",
    "FourRoomsEnv",
    "GoToDoorEnv",
    "GoToObjectEnv",
    "KeyCorridorEnv",
    "LavaGapEnv",
    "LockedRoomEnv",
    "MemoryEnv",
    "MultiRoomEnv",
    "ObstructedMazeEnv",
    "ObstructedMaze_1Dlhb",
    "ObstructedMaze_Full",
    "ObstructedMaze_Full_V1",
    "PlaygroundEnv",
    "PutNearEnv",
    "RedBlueDoorEnv",
    "UnlockEnv",
    "UnlockPickupEnv",
]

# -- WFC presets (reference: minigrid/envs/wfc/config.py:226-233) --
for _name in WFC_PRESETS:
    register(f"MiniGrid-WFC-{_name}-v0", WFCEnv, wfc_config=_name)
