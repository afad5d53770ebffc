"""Environment families; importing this package registers their ids, with
the JAX package's kwargs (``minigrid_tpu/envs/__init__.py:38-112``;
reference registration table: minigrid/__init__.py:36-261)."""

from __future__ import annotations

from minigrid_tpu_torch.envs import babyai as _babyai  # noqa: F401  (registers the BabyAI ids)
from minigrid_tpu_torch.envs.crossing import CrossingEnv
from minigrid_tpu_torch.envs.doorkey import DoorKeyEnv
from minigrid_tpu_torch.envs.dynamicobstacles import DynamicObstaclesEnv
from minigrid_tpu_torch.envs.empty import EmptyEnv
from minigrid_tpu_torch.envs.fetch import FetchEnv
from minigrid_tpu_torch.envs.fourrooms import FourRoomsEnv
from minigrid_tpu_torch.envs.gotodoor import GoToDoorEnv
from minigrid_tpu_torch.envs.gotoobject import GoToObjectEnv
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

__all__ = [
    "CrossingEnv",
    "DoorKeyEnv",
    "DynamicObstaclesEnv",
    "EmptyEnv",
    "FetchEnv",
    "FourRoomsEnv",
    "GoToDoorEnv",
    "GoToObjectEnv",
]
