"""Reward, action and termination wrappers (reference: minigrid/wrappers.py).

Counterpart of ``minigrid_tpu/wrappers/control.py``, on batched states.
Randomness comes from a ``torch.Generator`` the caller passes (None: the
device's default generator), where the JAX package splits the state's key.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from minigrid_tpu_torch.core.actions import Actions
from minigrid_tpu_torch.core.constants import OBJECT_TO_IDX, cell_type, dir_vec
from minigrid_tpu_torch.core.state import EnvState, resolve_device
from minigrid_tpu_torch.wrappers.base import Wrapper


@dataclass
class CountingState:
    """A bonus wrapper's state: the env state and its exploration counts
    int32 [N, ...], which persist across episodes as the reference's
    mutable ``self.counts`` dict does."""

    env: EnvState
    counts: torch.Tensor

    def replace(self, **changes) -> CountingState:
        return dataclasses.replace(self, **changes)


class _BonusWrapper(Wrapper):
    """Exploration bonus: reward += 1/sqrt(n), n the post-step count of the
    key ``_count_index`` gives, the counts carried in a ``CountingState``."""

    def _counts_shape(self) -> tuple[int, ...]:
        raise NotImplementedError

    def _count_index(self, stepped: EnvState, action) -> tuple[torch.Tensor, ...]:
        raise NotImplementedError

    def reset(self, num_envs: int, generator: torch.Generator | None = None, device=None):
        obs, env_state = self.env.reset(num_envs, generator, device)
        counts = torch.zeros((num_envs, *self._counts_shape()), dtype=torch.int32, device=env_state.device)
        return obs, CountingState(env=env_state, counts=counts)

    def step(self, state: CountingState, action, generator: torch.Generator | None = None):
        stepped, reward = self.env.step_env(state.env, action)
        n = state.counts.shape[0]
        flat = torch.zeros(n, dtype=torch.long, device=state.counts.device)
        for i, size in zip(self._count_index(stepped, action), self._counts_shape()):
            flat = flat * size + i.long()
        counts = state.counts.reshape(n, -1).clone()
        new_count = counts.gather(1, flat[:, None])[:, 0] + 1
        counts.scatter_(1, flat[:, None], new_count[:, None])
        reward = reward + 1.0 / torch.sqrt(new_count.float())
        env_state = self.env.autoreset(stepped, generator)
        return (
            self.observation(env_state),
            CountingState(env=env_state, counts=counts.reshape(state.counts.shape)),
            reward,
            stepped.terminated,
            stepped.truncated,
        )

    def observation(self, state, image: bool = True):
        if isinstance(state, CountingState):
            state = state.env
        return self.env.observation(state, image)


class ActionBonus(_BonusWrapper):
    """+1/sqrt(N(position, direction, action)) (reference:
    minigrid/wrappers.py:70-125); counts int32 [N, W, H, 4, 7]."""

    def _counts_shape(self):
        e = self.unwrapped
        return (e.width, e.height, 4, 7)

    def _count_index(self, stepped, action):
        action = torch.as_tensor(action, dtype=torch.int32, device=stepped.agent_x.device).expand_as(stepped.agent_x)
        return stepped.agent_x, stepped.agent_y, stepped.agent_dir, action


class PositionBonus(_BonusWrapper):
    """+1/sqrt(N(position)) (reference: minigrid/wrappers.py:128-187); counts
    int32 [N, W, H].

    Example:
        >>> import torch
        >>> import minigrid_tpu_torch as mgt
        >>> from minigrid_tpu_torch.wrappers import PositionBonus
        >>> env = PositionBonus(mgt.make("MiniGrid-Empty-5x5-v0"))
        >>> obs, state = env.reset(1, device="cpu")
        >>> done = torch.full((1,), 6)  # done: stay put
        >>> obs, state, reward, term, trunc = env.step(state, done)
        >>> float(reward[0])  # first visit of the start cell: +1/sqrt(1)
        1.0
        >>> obs, state, reward, term, trunc = env.step(state, done)
        >>> round(float(reward[0]), 4)  # second visit: +1/sqrt(2)
        0.7071
    """

    def _counts_shape(self):
        e = self.unwrapped
        return (e.width, e.height)

    def _count_index(self, stepped, action):
        return stepped.agent_x, stepped.agent_y


class StochasticActionWrapper(Wrapper):
    """Take the chosen action with probability ``prob``, else a random one
    (reference: minigrid/wrappers.py:773-794; the random one is drawn from
    [0, 6), never `done`, as the reference does), or ``random_action`` where
    it is given.  Draws from the generator that ``step`` is given."""

    def __init__(self, env, prob: float = 0.9, random_action: int | None = None):
        super().__init__(env)
        self.prob = float(prob)
        self.random_action = random_action

    def _perturb(self, action, n: int, device, generator):
        action = torch.as_tensor(action, dtype=torch.int32, device=device).expand(n)
        keep = torch.rand(n, generator=generator, device=device) < self.prob
        if self.random_action is None:
            alt = torch.randint(0, 6, (n,), generator=generator, device=device, dtype=torch.int32)
        else:
            alt = torch.full((n,), self.random_action, dtype=torch.int32, device=device)
        return torch.where(keep, action, alt)

    def step_env(self, state, action, generator: torch.Generator | None = None):
        n = state.step_count.shape[0]
        return self.env.step_env(state, self._perturb(action, n, state.device, generator))

    def step(self, state, action, generator: torch.Generator | None = None):
        stepped, reward = self.step_env(state, action, generator)
        state = self.env.autoreset(stepped, generator)
        return self.observation(state), state, reward, stepped.terminated, stepped.truncated


class NoDeath(Wrapper):
    """Deaths on the given cell types become a ``death_cost`` added to the
    reward and the episode goes on (reference: minigrid/wrappers.py:797-870).

    Example:
        >>> import torch
        >>> import minigrid_tpu_torch as mgt
        >>> from minigrid_tpu_torch.wrappers import NoDeath
        >>> env = NoDeath(mgt.make("MiniGrid-LavaCrossingS9N1-v0"), no_death_types=("lava",))
        >>> env.no_death_idx
        (9,)
    """

    def __init__(self, env, no_death_types: tuple[str, ...], death_cost: float = -1.0):
        if "goal" in no_death_types:
            raise ValueError("the goal cannot be a death type")
        super().__init__(env)
        self.death_cost = float(death_cost)
        self.no_death_idx = tuple(OBJECT_TO_IDX[t] for t in no_death_types)

    def _is_death_type(self, obj_type: torch.Tensor) -> torch.Tensor:
        m = torch.zeros_like(obj_type, dtype=torch.bool)
        for t in self.no_death_idx:
            m = m | (obj_type == t)
        return m

    def step_env(self, state, action):
        n, w, h = state.grid.shape
        rows = torch.arange(n, device=state.grid.device)
        dx, dy = dir_vec(state.agent_dir)
        fx = (state.agent_x + dx).clamp(0, w - 1)
        fy = (state.agent_y + dy).clamp(0, h - 1)
        fcell = state.grid[rows, fx.long(), fy.long()]
        action = torch.as_tensor(action, dtype=torch.int32, device=state.grid.device)
        going_to_death = (action == Actions.forward) & self._is_death_type(cell_type(fcell))

        stepped, reward = self.env.step_env(state, action)

        cur = stepped.grid[rows, stepped.agent_x.long(), stepped.agent_y.long()]
        cancel = stepped.terminated & (going_to_death | self._is_death_type(cell_type(cur)))
        reward = torch.where(cancel, reward + self.death_cost, reward)
        return stepped.replace(terminated=stepped.terminated & ~cancel), reward


class ReseedWrapper(Wrapper):
    """Deterministic evaluation: each reset draws from a ``torch.Generator``
    seeded with the next seed of a fixed list, cycling (reference:
    minigrid/wrappers.py:17-67).  The cycle is the JAX package's; the levels
    of a seed are the generator's, not JAX's (generation is held to JAX by
    distribution).  A generator passed to ``reset`` gives only its device.

    Example:
        >>> import torch
        >>> import minigrid_tpu_torch as mgt
        >>> from minigrid_tpu_torch.wrappers import ReseedWrapper
        >>> env = ReseedWrapper(mgt.make("MiniGrid-Empty-Random-5x5-v0"), seeds=[3, 5])
        >>> _, s1 = env.reset(4, device="cpu")
        >>> _, s2 = env.reset(4, device="cpu")
        >>> _, s3 = env.reset(4, device="cpu")  # cycles back to seed 3
        >>> torch.equal(s1.agent_pos, s3.agent_pos)
        True
    """

    def __init__(self, env, seeds=(0,), seed_idx: int = 0):
        super().__init__(env)
        self.seeds = list(seeds)
        self.seed_idx = int(seed_idx)

    def reset(self, num_envs: int, generator: torch.Generator | None = None, device=None):
        device = resolve_device(generator, device)
        seed = self.seeds[self.seed_idx]
        self.seed_idx = (self.seed_idx + 1) % len(self.seeds)
        return self.env.reset(num_envs, torch.Generator(device=device).manual_seed(seed), device)
