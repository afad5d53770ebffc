"""Gymnasium single-env host adapter.

Counterpart of ``minigrid_tpu/compat/gym.py``.  The native API here is
batched (``reset``/``step`` over an ``EnvState`` with a leading env axis);
this shim wraps one env instance, a batch of one, in the mutable
``gymnasium.Env`` protocol so existing gymnasium tooling (``check_env``,
wrappers, SyncVectorEnv) and reference-style user code work unchanged
(reference surface: minigrid/minigrid_env.py:24-157).  It is a
conformance/interop layer, not the hot path — rollouts at scale should stay
on the batched API.

The state lives on ``device``: the card unless the caller passes
``device="cpu"``.  Every observation is one call of the observation kernel
on the card (``core/obs.gen_obs``), and each ``reset``/``step`` reads its
results back to the host in one transfer.

gymnasium is optional.  Without it the shim is a plain class with the same
``reset``/``step``/``render``/``close`` and view-query API and no
``action_space``/``observation_space``; ``np_random`` is this package's own
copy of gymnasium's seeding (``compat/parity.np_random``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from minigrid_tpu_torch.compat.parity import ParityRollout, _without_templates, np_random
from minigrid_tpu_torch.core.actions import NUM_ACTIONS
from minigrid_tpu_torch.core.constants import DIR_TO_VEC, OBJ_AGENT, OBJ_EMPTY, OBJ_UNSEEN
from minigrid_tpu_torch.core.state import resolve_device
from minigrid_tpu_torch.registry import make

try:  # gymnasium is optional; the adapter degrades to a plain class.
    import gymnasium as _gym

    _EnvBase = _gym.Env
except ImportError:
    _gym = None
    _EnvBase = object


def _episode_seed(base_seed: int, episode: int) -> int:
    """The seed of the ``torch.Generator`` that draws episode ``episode``
    after ``reset(seed=base_seed)`` in normal mode (the JAX package folds the
    episode into ``PRNGKey(base_seed)``)."""
    return int(np.random.SeedSequence([base_seed, episode]).generate_state(1, np.uint64)[0])


class GymnasiumMiniGrid(_EnvBase):
    """``gymnasium.Env`` adapter over a batched env family."""

    metadata = {"render_modes": ["human", "rgb_array"], "render_fps": 10}

    def __init__(
        self,
        env,
        render_mode: str | None = None,
        tile_size: int = 32,
        screen_size: int = 640,
        highlight: bool = True,
        agent_pov: bool = False,
        parity: bool = False,
        device=None,
    ):
        self.env = env
        self.device = resolve_device(None, device)
        self.render_mode = render_mode
        self.tile_size = tile_size
        self.screen_size = screen_size
        self.highlight = highlight
        self.agent_pov = agent_pov
        # pygame window state for render_mode="human"
        # (reference: minigrid/minigrid_env.py:89-92).
        self.window = None
        self.clock = None
        self.state = None
        self._episode = 0
        self._base_seed = 0
        self._generator = torch.Generator(device=self.device)
        self._np_random = None
        self._np_random_seed = None
        # Seed-parity mode: reset(seed=s) rebuilds exactly the episode the
        # reference builds for s (compat/parity.py), and step-time RNG
        # (DynamicObstacles obstacle walk) is host-mirrored.
        self.parity = bool(parity)
        self._parity_roll = None

        if _gym is not None:
            v = env.agent_view_size
            self.action_space = _gym.spaces.Discrete(NUM_ACTIONS)
            self.observation_space = _gym.spaces.Dict(
                {
                    "image": _gym.spaces.Box(0, 255, (v, v, 3), dtype=np.uint8),
                    "direction": _gym.spaces.Discrete(4),
                    "mission": _gym.spaces.Text(
                        max_length=256,
                        charset=frozenset("abcdefghijklmnopqrstuvwxyz ,0123456789"),
                    ),
                }
            )
        self.reward_range = getattr(env, "reward_range", (0.0, 1.0))
        self.spec = None

    # -- seeding (gymnasium.Env's contract, on this package's seeding) ---------
    @property
    def np_random(self) -> np.random.Generator:
        if self._np_random is None:
            self._np_random, self._np_random_seed = np_random()
        return self._np_random

    @np_random.setter
    def np_random(self, value: np.random.Generator) -> None:
        self._np_random = value
        self._np_random_seed = -1

    @property
    def np_random_seed(self) -> int:
        if self._np_random_seed is None:
            self._np_random, self._np_random_seed = np_random()
        return self._np_random_seed

    # -- gymnasium protocol ----------------------------------------------------
    def reset(self, *, seed: int | None = None, options: dict | None = None):
        if seed is not None:
            self._np_random, self._np_random_seed = np_random(seed)
        if self.parity:
            if self._parity_roll is None:
                self._parity_roll = ParityRollout(self.env, seed, self.device)
            else:
                self._parity_roll.new_episode(seed)
            self.state = self._parity_roll.state
            obs = self.env.observation(self.state)
        else:
            if seed is not None:
                self._base_seed = seed
                self._episode = 0
            self._generator.manual_seed(_episode_seed(self._base_seed, self._episode))
            self._episode += 1
            obs, self.state = self.env.reset(1, self._generator, self.device)
        out, _ = self._to_host(obs)
        # Reference opens/refreshes the pygame window on reset in human mode
        # (minigrid/minigrid_env.py:151-152).
        if self.render_mode == "human":
            self.render()
        return out, {}

    def step(self, action):
        if self.state is None:
            raise RuntimeError("call reset() before step()")
        if self.parity:
            self.state, reward = self._parity_roll.advance(int(action))
        else:
            a = torch.full((1,), int(action), dtype=torch.int32, device=self.device)
            self.state, reward = self.env.step_env(self.state, a)
        obs = self.env.observation(self.state)
        out, (r, terminated, truncated) = self._to_host(obs, reward, self.state.terminated, self.state.truncated)
        # Reference renders every step in human mode (minigrid_env.py:590-591).
        if self.render_mode == "human":
            self.render()
        return out, r, bool(terminated), bool(truncated), {}

    def render(self):
        if self.state is None:
            return None
        frame = self.env.get_frame(
            self.state, highlight=self.highlight, tile_size=self.tile_size, agent_pov=self.agent_pov
        )
        img = frame[0].cpu().numpy()
        if self.render_mode == "human":
            self._render_human(img)
            return None
        return img

    def _render_human(self, img: np.ndarray) -> None:
        """Live pygame window with the mission caption — the reference's
        human-mode path (minigrid/minigrid_env.py:744-782): transpose to
        pygame's (x, y) surface layout, white margin, mission text centered
        near the bottom, smoothscale to ``screen_size``, clock.tick at
        ``metadata["render_fps"]``."""
        import pygame
        import pygame.freetype

        img = np.transpose(img, axes=(1, 0, 2))
        if self.window is None:
            pygame.init()
            pygame.display.init()
            self.window = pygame.display.set_mode((self.screen_size, self.screen_size))
            pygame.display.set_caption("minigrid")
        if self.clock is None:
            self.clock = pygame.time.Clock()
        surf = pygame.surfarray.make_surface(img)

        offset = surf.get_size()[0] * 0.1
        bg = pygame.Surface((int(surf.get_size()[0] + offset), int(surf.get_size()[1] + offset)))
        bg.convert()
        bg.fill((255, 255, 255))
        bg.blit(surf, (offset / 2, 0))
        bg = pygame.transform.smoothscale(bg, (self.screen_size, self.screen_size))

        font_size = 22
        text = self.mission
        font = pygame.freetype.SysFont(pygame.font.get_default_font(), font_size)
        text_rect = font.get_rect(text, size=font_size)
        text_rect.center = bg.get_rect().center
        text_rect.y = bg.get_height() - font_size * 1.5
        font.render_to(bg, text_rect, text, size=font_size)

        self.window.blit(bg, (0, 0))
        pygame.event.pump()
        self.clock.tick(self.metadata["render_fps"])
        pygame.display.flip()

    def close(self):
        if self.window is not None:
            import pygame

            pygame.quit()
            self.window = None

    # -- pickling (reference conformance: tests/test_envs.py:174-184 pickles
    # the env and requires the clone to behave identically) -------------------
    def __getstate__(self):
        # The pygame window and clock are process-local handles; the state
        # and the generator's position travel on the CPU and return to the
        # env's device; everything else (env family config, episode
        # counters, parity rollout) round-trips.
        state = self.__dict__.copy()
        state["window"] = state["clock"] = None
        state["env"] = _without_templates(self.env)
        state["state"] = None if self.state is None else self.state.map(lambda t: t.cpu())
        state["_generator"] = self._generator.get_state()
        state["device"] = str(self.device)
        return state

    def __setstate__(self, state):
        generator_state = state.pop("_generator")
        self.__dict__.update(state)
        self.device = torch.device(self.device)
        self._generator = torch.Generator(device=self.device)
        self._generator.set_state(generator_state)
        if self.state is not None:
            self.state = self.state.map(lambda t: t.to(self.device))

    @property
    def unwrapped(self):
        return self

    # -- conveniences mirroring the reference's attribute surface ---------------
    def _pose(self) -> list[int]:
        s = self.state
        return torch.cat([s.agent_x, s.agent_y, s.agent_dir, s.step_count, s.max_steps, s.carrying]).tolist()

    @property
    def agent_pos(self):
        x, y = self._pose()[:2]
        return (x, y)

    @property
    def agent_dir(self) -> int:
        return self._pose()[2]

    @property
    def step_count(self) -> int:
        return self._pose()[3]

    @property
    def max_steps(self) -> int:
        return self._pose()[4]

    @property
    def mission(self) -> str:
        return self.env.mission_text(self.state.mission[0].tolist())

    @property
    def steps_remaining(self) -> int:
        # reference: minigrid/minigrid_env.py:171-173
        return self.max_steps - self.step_count

    @property
    def carrying(self) -> tuple[int, int] | None:
        """(type, color) of the carried object, or None (the state packs
        carrying as one int; reference keeps a WorldObj)."""
        c = self._pose()[5]
        return None if c == 0 else (c & 0xFF, (c >> 8) & 0xFF)

    @property
    def dir_vec(self):
        # reference: minigrid/minigrid_env.py:397-407
        d = self.agent_dir
        if not 0 <= d < 4:
            raise ValueError(f"Invalid agent_dir: {d} is not within range(0, 4)")
        return np.asarray(DIR_TO_VEC)[d]

    @property
    def right_vec(self):
        dx, dy = self.dir_vec
        return np.array((-dy, dx))

    @property
    def front_pos(self):
        return np.asarray(self.agent_pos) + self.dir_vec

    def get_view_coords(self, i, j):
        """World (i, j) -> agent-view coordinates; may land outside the view
        (reference: minigrid/minigrid_env.py:426-451)."""
        ax, ay = self.agent_pos
        dx, dy = self.dir_vec
        rx, ry = self.right_vec
        sz = self.env.agent_view_size
        hs = sz // 2
        tx = ax + dx * (sz - 1) - rx * hs
        ty = ay + dy * (sz - 1) - ry * hs
        lx, ly = i - tx, j - ty
        return int(rx * lx + ry * ly), int(-(dx * lx + dy * ly))

    def relative_coords(self, x, y):
        """View coords of world (x, y), or None when outside the view box
        (reference: minigrid/minigrid_env.py:486-496)."""
        vx, vy = self.get_view_coords(x, y)
        sz = self.env.agent_view_size
        if vx < 0 or vy < 0 or vx >= sz or vy >= sz:
            return None
        return vx, vy

    def in_view(self, x, y) -> bool:
        return self.relative_coords(x, y) is not None

    def agent_sees(self, x, y) -> bool:
        """True when the non-empty world cell (x, y) is inside the view box
        AND survives occlusion, judged exactly like the reference — by
        comparing the encoded observation's type against the world cell's
        (reference: minigrid/minigrid_env.py:505-523, including its check
        that the queried cell is non-empty)."""
        coordinates = self.relative_coords(x, y)
        if coordinates is None:
            return False
        vx, vy = coordinates

        obs = self.env.observation(self.state)
        obs_type, world_type = torch.stack(
            [obs["image"][0, vx, vy, 0].to(torch.int32), self.state.grid[0, x, y] & 0xFF]
        ).tolist()
        if world_type == OBJ_EMPTY:  # reference asserts world_cell is not None
            raise ValueError(f"agent_sees: world cell ({x}, {y}) is empty")
        # Grid.decode maps unseen/empty/agent to None (world_object.py:77-78).
        return obs_type not in (OBJ_UNSEEN, OBJ_EMPTY, OBJ_AGENT) and obs_type == world_type

    def hash(self, size: int = 16) -> str:
        from minigrid_tpu_torch.utils.debug import state_hash

        return state_hash(self.state, size)

    def pprint_grid(self) -> str:
        from minigrid_tpu_torch.utils.debug import pprint_grid

        return pprint_grid(self.state)

    def __str__(self):
        return self.pprint_grid()

    # -- internals -----------------------------------------------------------------
    def _to_host(self, obs, *scalars: torch.Tensor) -> tuple[dict[str, Any], list[float]]:
        """The observation of env 0 as the reference's dict, and
        ``scalars`` (rewards, flags of the batch of one) as floats: all of
        it read back in one transfer (every value is exact in float64)."""
        image, mission = obs["image"][0], obs["mission"][0]
        parts = [image.reshape(-1), obs["direction"][:1], mission, *(s.reshape(-1)[:1] for s in scalars)]
        flat = torch.cat([p.to(torch.float64) for p in parts]).cpu().numpy()
        n_image, n_mission = image.numel(), mission.numel()
        out = {
            "image": flat[:n_image].astype(np.uint8).reshape(tuple(image.shape)),
            "direction": int(flat[n_image]),
            "mission": self.env.mission_text(flat[n_image + 1 : n_image + 1 + n_mission].astype(np.int32)),
        }
        return out, flat[n_image + 1 + n_mission :].tolist()


def gym_make(
    env_id: str,
    render_mode: str | None = None,
    parity: bool = False,
    device=None,
    **kwargs,
):
    """``gym.make``-alike returning the adapter directly.

    Display kwargs (``tile_size``/``screen_size``/``highlight``/``agent_pov``,
    the reference's MiniGridEnv ctor surface, minigrid_env.py:34-48) go to the
    adapter; everything else goes to the env family constructor.
    ``parity=True`` makes ``reset(seed=s)`` reproduce the reference's episode
    for ``s`` bit-exactly (see minigrid_tpu_torch/compat/parity.py).  The
    state lives on ``device``, the card unless the caller asks for the CPU."""
    shim_kwargs = {
        k: kwargs.pop(k)
        for k in ("tile_size", "screen_size", "highlight", "agent_pov")
        if k in kwargs
    }
    return GymnasiumMiniGrid(
        make(env_id, **kwargs), render_mode=render_mode, parity=parity, device=device,
        **shim_kwargs,
    )


def register_gymnasium_envs(prefix: str = "") -> int:
    """Register every env id into the gymnasium registry so literal
    ``gymnasium.make(prefix + "MiniGrid-…")`` works (the reference wires this
    as a package entry point, reference pyproject.toml
    [project.entry-points."gymnasium.envs"] -> minigrid/__init__.py:24).

    Returns the number of ids registered.  ``prefix`` namespaces the ids
    (e.g. "Torch/").  An id this package registered before is left as it is;
    an id that something else registered (the JAX package's entry point
    registers the same 177 names) raises ``ValueError``: pass a prefix.
    ``gymnasium.make`` passes its kwargs on, ``device="cpu"`` among them.
    """
    import gymnasium as gym

    from minigrid_tpu_torch.registry import registered_ids

    count = 0
    for env_id in registered_ids():
        gym_id = prefix + env_id
        spec = gym.envs.registry.get(gym_id)
        if spec is not None:
            if spec.entry_point is not _gym_entry_point:
                raise ValueError(
                    f"{gym_id!r} is already registered by {spec.entry_point!r}; "
                    "register this package's envs under a prefix"
                )
            continue
        gym.register(
            id=gym_id,
            entry_point=_gym_entry_point,
            kwargs={"minigrid_tpu_env_id": env_id},
        )
        count += 1
    return count


def _gym_entry_point(minigrid_tpu_env_id: str, render_mode=None, **kwargs):
    return gym_make(minigrid_tpu_env_id, render_mode=render_mode, **kwargs)
