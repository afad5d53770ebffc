"""Environment families; importing this package registers their ids, with
the JAX package's kwargs (``minigrid_tpu/envs/__init__.py:38-98``; reference
registration table: minigrid/__init__.py:36-160)."""

from __future__ import annotations

from minigrid_tpu_torch.envs.crossing import CrossingEnv
from minigrid_tpu_torch.envs.dynamicobstacles import DynamicObstaclesEnv
from minigrid_tpu_torch.envs.empty import EmptyEnv
from minigrid_tpu_torch.registry import register

# -- Empty --
register("MiniGrid-Empty-5x5-v0", EmptyEnv, size=5)
register("MiniGrid-Empty-Random-5x5-v0", EmptyEnv, size=5, agent_start_pos=None)
register("MiniGrid-Empty-6x6-v0", EmptyEnv, size=6)
register("MiniGrid-Empty-Random-6x6-v0", EmptyEnv, size=6, agent_start_pos=None)
register("MiniGrid-Empty-8x8-v0", EmptyEnv)
register("MiniGrid-Empty-16x16-v0", EmptyEnv, size=16)

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

__all__ = ["CrossingEnv", "DynamicObstaclesEnv", "EmptyEnv"]
