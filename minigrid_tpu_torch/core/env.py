"""Batched environment base class.

Counterpart of ``minigrid_tpu/core/env.py``.  An env instance holds static
configuration only; every method takes and returns a batched ``EnvState``
(leading env axis), where the JAX package ``vmap``s single-env functions.
Randomness comes from an explicit ``torch.Generator`` on the state's device.

Auto-reset is fused into ``step``: where an episode ends, the returned state
is a fresh episode, while ``terminated``/``truncated`` report the episode that
ended.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import obs as obs_lib
from minigrid_tpu_torch.core.actions import NUM_ACTIONS
from minigrid_tpu_torch.core.mission import mission_to_text
from minigrid_tpu_torch.core.state import EnvState, select
from minigrid_tpu_torch.core.step import core_step


class MiniGridEnv:
    """Base of every family.  A family implements ``_generate`` (the
    reference's ``_gen_grid``, minigrid/minigrid_env.py:236-238) and may
    override the step hooks."""

    # ``_generate`` builds the same level whatever the generator draws
    # (fixed-start Empty): a 1-slot reset cache then reproduces the
    # reference's fresh-level-per-reset contract exactly
    # (parallel/reset_budget.py).
    deterministic_generation: bool = False
    # Kernel specialisations (ops/fused_rollout.py).  ``fused_no_objects``:
    # no cell the core step can change (no keys, balls, boxes or doors), so
    # pickup, drop and toggle never fire.  ``fused_static_mission``: the
    # mission vector is a family constant, so resets never change it.
    fused_no_objects: bool = False
    fused_static_mission: bool = False

    def __init__(
        self,
        width: int,
        height: int,
        max_steps: int,
        see_through_walls: bool = False,
        agent_view_size: int = 7,
    ):
        if agent_view_size % 2 != 1 or agent_view_size < 3:
            raise ValueError(f"agent_view_size must be odd and >= 3, got {agent_view_size}")
        self.width = int(width)
        self.height = int(height)
        self.max_steps = int(max_steps)
        self.see_through_walls = bool(see_through_walls)
        self.agent_view_size = int(agent_view_size)

    @property
    def num_actions(self) -> int:
        return NUM_ACTIONS

    # -- provided by families ------------------------------------------------
    def _generate(self, num_envs: int, generator: torch.Generator | None, device) -> EnvState:
        raise NotImplementedError

    def _map_action(self, action: torch.Tensor) -> torch.Tensor:
        """Remap actions before the core step (e.g. Memory's pickup->toggle,
        minigrid/envs/memory.py:154)."""
        return action

    def _pre_step(self, state: EnvState, action: torch.Tensor) -> EnvState:
        """Dynamics that run before the agent acts (e.g. moving obstacles)."""
        return state

    def _post_step(self, prev: EnvState, state: EnvState, action, reward):
        """Family reward and termination overlay."""
        return state, reward

    # -- batched API -----------------------------------------------------------
    def observation(self, state: EnvState) -> dict:
        return obs_lib.gen_obs(state, self.agent_view_size, self.see_through_walls)

    def reset(self, num_envs: int, generator: torch.Generator | None = None, device=None):
        """``num_envs`` fresh episodes; returns (obs, state)."""
        state = self._generate(num_envs, generator, device)
        return self.observation(state), state

    def step_env(self, state: EnvState, action: torch.Tensor):
        """One transition without auto-reset; returns (state, reward)."""
        mapped = self._map_action(action)
        state = self._pre_step(state, action)
        prev = state
        state, reward = core_step(state, mapped)
        return self._post_step(prev, state, action, reward)

    def autoreset(self, stepped: EnvState, generator: torch.Generator | None = None) -> EnvState:
        """Replace every ended episode by a freshly generated one."""
        done = stepped.terminated | stepped.truncated
        fresh = self._generate(done.shape[0], generator, stepped.device)
        return select(done, fresh, stepped)

    def step(self, state: EnvState, action: torch.Tensor, generator: torch.Generator | None = None):
        """Transition with auto-reset; returns (obs, state, reward,
        terminated, truncated)."""
        stepped, reward = self.step_env(state, action)
        state = self.autoreset(stepped, generator)
        return self.observation(state), state, reward, stepped.terminated, stepped.truncated

    def reset_cache(self, num_resets: int, generator: torch.Generator | None = None, device=None):
        """``num_resets`` fresh episodes for one env (leading axis R)."""
        return self._generate(num_resets, generator, device)

    def batch_reset_cache(
        self, num_envs: int, num_resets: int, generator: torch.Generator | None = None, device=None
    ) -> EnvState:
        """Reset cache with leaves [num_envs, num_resets, ...]."""
        flat = self._generate(num_envs * num_resets, generator, device)
        return flat.map(lambda a: a.reshape((num_envs, num_resets) + a.shape[1:]))

    def step_cached(self, state: EnvState, action: torch.Tensor, cache: EnvState, used: torch.Tensor):
        """Transition with auto-reset drawn from a pre-generated cache.

        ``cache`` holds R fresh episodes per env ([N, R, ...]) and ``used``
        (int32[N]) counts resets already consumed: an ending episode takes slot
        min(used, R-1), then ``used`` grows by one.  Past R resets the last
        slot is replayed, which the reference's fresh-reset contract never
        does, so callers size R with ``parallel/reset_budget.resets_for`` and
        check ``used`` against it.

        Returns (obs, state, reward, terminated, truncated, used).
        """
        stepped, reward = self.step_env(state, action)
        done = stepped.terminated | stepped.truncated
        state = select(done, cache_slot(cache, used), stepped)
        obs = self.observation(state)
        return obs, state, reward, stepped.terminated, stepped.truncated, used + done.int()

    def mission_text(self, mission) -> str:
        """The reference's mission string of one mission vector."""
        return mission_to_text(mission)


def cache_slot(cache: EnvState, used: torch.Tensor) -> EnvState:
    """Slot min(used, R-1) of every env's reset cache ([N, R, ...] -> [N, ...])."""
    n, r = cache.step_count.shape
    rows = torch.arange(n, device=used.device)
    slot = used.clamp(max=r - 1).long()
    return cache.map(lambda a: a[rows, slot])
