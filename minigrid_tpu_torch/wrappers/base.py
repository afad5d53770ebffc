"""Wrapper base.

Counterpart of ``minigrid_tpu/wrappers/base.py``.  The reference's wrappers
subclass gymnasium's mutable Wrapper protocol (minigrid/wrappers.py); here a
wrapper is an env-like object that delegates to an inner env and takes and
returns batched states (leading env axis), as the env does.  Observation
wrappers override ``observation(state)``; wrappers with memory of their own
(the exploration bonuses) carry it beside the env state
(``wrappers/control.CountingState``).

A wrapped env takes the plain path of ``rollout_random``: the
whole-rollout kernel runs only the default observation
(``ops/fused_rollout.supports_fused``), and a wrapper's ``observation`` is
not that.

A dict observation's ``observation(state, image=False)`` leaves out the
image: a wrapper that replaces the image asks its inner env for the rest
that way.  Under XLA's jit the inner view that such a wrapper drops is dead
code; in eager PyTorch it would be a second observation-kernel launch and
unpacking every step.  ``ImgObsWrapper`` and ``FlatObsWrapper``, whose
observation is (made from) the image itself, take no ``image`` flag.  A
reset still observes the inner env in full, once for a batch of episodes.
"""

from __future__ import annotations

import torch


class Wrapper:
    """Transparent delegating wrapper."""

    def __init__(self, env):
        self.env = env

    def __getattr__(self, name):
        # Reached only for names the wrapper lacks; "env" itself is missing
        # only while an unpickled or copied wrapper is being rebuilt.
        if name == "env":
            raise AttributeError(name)
        return getattr(self.env, name)

    @property
    def unwrapped(self):
        e = self.env
        while isinstance(e, Wrapper):
            e = e.env
        return e

    def reset(self, num_envs: int, generator: torch.Generator | None = None, device=None):
        _, state = self.env.reset(num_envs, generator, device)
        return self.observation(state), state

    def step_env(self, state, action):
        return self.env.step_env(state, action)

    def step(self, state, action, generator: torch.Generator | None = None):
        stepped, reward = self.step_env(state, action)
        state = self.env.autoreset(stepped, generator)
        return self.observation(state), state, reward, stepped.terminated, stepped.truncated

    def observation(self, state, image: bool = True):
        return self.env.observation(state, image)
