"""Demonstration generation with the oracle bot.

Counterpart of ``minigrid_tpu/utils/demos.py``: the reference's BabyAIBot
exists to generate expert demonstrations for imitation learning
(reference: minigrid/utils/baby_ai_bot.py:549-562).  This module drives the
bot over any BabyAI level and collects (observation, action) trajectories
as stacked numpy arrays ready for a BC/DAgger data pipeline.

The episode lives on ``device``, the card unless the caller passes
``device="cpu"``: each observation is one launch of the observation kernel
there.  A seed's level comes from a ``torch.Generator`` seeded with it on
that device, so it is not the JAX package's level of the same seed, and the
card's and the CPU's generators give different levels too.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from minigrid_tpu_torch.core.state import resolve_device
from minigrid_tpu_torch.utils.babyai_bot import BabyAIBot, DisappearedBoxError


class Demo(NamedTuple):
    images: np.ndarray  # uint8[T, v, v, 3]
    directions: np.ndarray  # int32[T]
    missions: np.ndarray  # int32[T, M]
    actions: np.ndarray  # int32[T]
    reward: float
    seed: int


def generate_demo(env, seed: int, max_steps: int = 600, device=None) -> Demo | None:
    """One expert episode; None if the bot fails on this seed."""
    device = resolve_device(None, device)
    generator = torch.Generator(device=device).manual_seed(seed)
    obs, state = env.reset(1, generator)
    bot = BabyAIBot(env, state)
    images, dirs, missions, actions = [], [], [], []
    last_action = None
    for _ in range(max_steps):
        try:
            action = bot.replan(state, last_action)
        except (DisappearedBoxError, RuntimeError, AssertionError):
            return None
        images.append(obs["image"][0])
        dirs.append(obs["direction"][0])
        missions.append(obs["mission"][0])
        actions.append(action)
        state, reward = env.step_env(state, torch.tensor([action], dtype=torch.int32, device=device))
        obs = env.observation(state)
        last_action = action
        terminated, truncated = torch.stack([state.terminated[0], state.truncated[0]]).tolist()
        if terminated:
            reward = float(reward[0])
            if reward <= 0:
                return None
            return Demo(
                torch.stack(images).cpu().numpy(),
                torch.stack(dirs).cpu().numpy(),
                torch.stack(missions).cpu().numpy(),
                np.asarray(actions, np.int32),
                reward,
                seed,
            )
        if truncated:
            return None
    return None


def generate_demos(env, num_demos: int, start_seed: int = 0, max_steps: int = 600, device=None) -> list[Demo]:
    """Collect ``num_demos`` successful expert episodes (skipping seeds the
    bot cannot solve, like the reference's seed-retry loop in
    tests/test_baby_ai_bot.py:38-56)."""
    demos: list[Demo] = []
    seed = start_seed
    while len(demos) < num_demos:
        demo = generate_demo(env, seed, max_steps, device)
        if demo is not None:
            demos.append(demo)
        seed += 1
    return demos
