"""Interactive keyboard driver (reference: minigrid/manual_control.py:14-139).

Counterpart of ``minigrid_tpu/manual_control.py``.  Drives one env, a batch
of one, with arrow keys in a pygame window.  The controller owns the
``EnvState`` and threads it through ``step_env`` (no auto-reset: an episode
end triggers an explicit re-reset, like the reference).  The state lives on
``device``, the card unless the caller passes ``device="cpu"``; every frame
is one launch of the observation kernel there.

Each episode's level comes from a ``torch.Generator`` seeded from (seed,
episode) as the gymnasium shim's normal mode seeds its episodes
(``compat/gym._episode_seed``): with ``--seed`` every reset replays the same
level, as in the JAX package, whose ``fold_in(PRNGKey(seed), episode)`` this
package cannot replay.

pygame is imported only to draw, read keys and close a window (``render``,
``start``, ``close`` where a window is open), so the controller and its key
handler run without it where nothing draws (the display stubbed).

Usage::

    python -m minigrid_tpu_torch.manual_control --env-id MiniGrid-MultiRoom-N6-v0
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from minigrid_tpu_torch.compat.gym import _episode_seed
from minigrid_tpu_torch.core.actions import Actions
from minigrid_tpu_torch.core.state import resolve_device
from minigrid_tpu_torch.registry import make, registered_ids

KEY_TO_ACTION = {
    "left": Actions.left,
    "right": Actions.right,
    "up": Actions.forward,
    "space": Actions.toggle,
    "pageup": Actions.pickup,
    "pagedown": Actions.drop,
    "tab": Actions.pickup,
    "left shift": Actions.drop,
    "enter": Actions.done,
}


class ManualControl:
    """Blocking pygame event loop mapping keys to actions."""

    def __init__(
        self,
        env,
        seed: int | None = None,
        tile_size: int = 32,
        screen_size: int = 640,
        agent_pov: bool = False,
        device=None,
    ):
        self.env = env
        self.seed = seed
        self.tile_size = tile_size
        self.screen_size = screen_size
        self.agent_pov = agent_pov
        self.device = resolve_device(None, device)
        self.closed = False
        self.state = None
        self.window = None
        self._generator = torch.Generator(device=self.device)
        self._episode = 0

    # -- episode control -------------------------------------------------------
    def reset(self):
        seed = self.seed if self.seed is not None else np.random.randint(0, 2**31)
        self._generator.manual_seed(_episode_seed(seed, self._episode))
        if self.seed is None:
            self._episode += 1
        _, self.state = self.env.reset(1, self._generator)
        print("mission:", self.env.mission_text(self.state.mission[0].cpu()))
        self.render()

    def step(self, action: Actions):
        action = torch.tensor([int(action)], dtype=torch.int32, device=self.device)
        self.state, reward = self.env.step_env(self.state, action)
        step_count, terminated, truncated = torch.stack(
            [self.state.step_count[0], self.state.terminated[0].int(), self.state.truncated[0].int()]
        ).tolist()
        print(f"step={step_count}, reward={float(reward[0]):.2f}")
        if terminated:
            print("terminated!")
            self.reset()
        elif truncated:
            print("truncated!")
            self.reset()
        else:
            self.render()

    def frame(self) -> np.ndarray:
        """uint8 [rows, columns, 3] RGB frame of the current state."""
        frame = self.env.get_frame(self.state, tile_size=self.tile_size, agent_pov=self.agent_pov)
        return frame[0].cpu().numpy()

    # -- pygame ------------------------------------------------------------------
    def render(self):
        import pygame

        frame = self.frame()
        if self.window is None:
            pygame.init()
            pygame.display.init()
            self.window = pygame.display.set_mode((self.screen_size, self.screen_size))
            pygame.display.set_caption("minigrid-tpu")
        surf = pygame.surfarray.make_surface(frame.transpose(1, 0, 2))
        surf = pygame.transform.smoothscale(surf, (self.screen_size, self.screen_size))
        self.window.blit(surf, (0, 0))
        pygame.display.flip()

    def close(self):
        self.closed = True
        if self.window is not None:
            import pygame

            pygame.display.quit()
            pygame.quit()
            self.window = None

    def start(self):
        import pygame

        self.reset()
        while not self.closed:
            for event in pygame.event.get():
                if event.type == pygame.QUIT:
                    self.close()
                    break
                if event.type == pygame.KEYDOWN:
                    event.key = pygame.key.name(int(event.key))
                    self.key_handler(event)

    def key_handler(self, event):
        key: str = event.key
        if key == "escape":
            self.close()
            return
        if key == "backspace":
            self.reset()
            return
        if key in KEY_TO_ACTION:
            self.step(KEY_TO_ACTION[key])
        else:
            print("pressed", key)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "--env-id",
        default="MiniGrid-MultiRoom-N6-v0",
        choices=registered_ids(),
        metavar="ENV_ID",
    )
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--tile-size", type=int, default=32)
    parser.add_argument(
        "--agent-view",
        action="store_true",
        help="render the agent's partially observable view",
    )
    parser.add_argument("--agent-view-size", type=int, default=7)
    parser.add_argument("--screen-size", type=int, default=640)
    parser.add_argument("--device", default=None, help="torch device of the state (default: CUDA)")
    args = parser.parse_args(argv)

    env = make(args.env_id, agent_view_size=args.agent_view_size)
    ManualControl(
        env,
        seed=args.seed,
        tile_size=args.tile_size,
        screen_size=args.screen_size,
        agent_pov=args.agent_view,
        device=args.device,
    ).start()


if __name__ == "__main__":
    main()
