"""The learners: the actor-critic network, on-policy collection, PPO and IMPALA."""

from minigrid_tpu_torch.rl.impala import IMPALAConfig, make_impala, vtrace
from minigrid_tpu_torch.rl.model import ActorCritic, apply_packed_fused
from minigrid_tpu_torch.rl.ppo import PPOConfig, TrainState, make_ppo, make_train
from minigrid_tpu_torch.rl.rollout import Trajectory, collect_trajectory

__all__ = [
    "ActorCritic",
    "IMPALAConfig",
    "PPOConfig",
    "TrainState",
    "Trajectory",
    "apply_packed_fused",
    "collect_trajectory",
    "make_impala",
    "make_ppo",
    "make_train",
    "vtrace",
]
