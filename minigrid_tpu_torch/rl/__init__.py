"""The learners: the actor-critic network, on-policy collection and PPO."""

from minigrid_tpu_torch.rl.model import ActorCritic, apply_packed_fused
from minigrid_tpu_torch.rl.ppo import PPOConfig, TrainState, make_ppo, make_train
from minigrid_tpu_torch.rl.rollout import Trajectory, collect_trajectory

__all__ = [
    "ActorCritic",
    "PPOConfig",
    "TrainState",
    "Trajectory",
    "apply_packed_fused",
    "collect_trajectory",
    "make_ppo",
    "make_train",
]
