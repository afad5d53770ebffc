"""RGB observation wrappers (reference: minigrid/wrappers.py:290-381).

Counterpart of ``minigrid_tpu/wrappers/rgb.py``; frames come from
``render/frame.get_frame``, batched over the leading env axis.
"""

from __future__ import annotations

from minigrid_tpu_torch.render.frame import get_frame
from minigrid_tpu_torch.wrappers.base import Wrapper


class RGBImgObsWrapper(Wrapper):
    """Full-grid RGB frame as the image, uint8 [N, H*ts, W*ts, 3]
    (reference: minigrid/wrappers.py:290-334).

    Example:
        >>> import minigrid_tpu_torch as mgt
        >>> from minigrid_tpu_torch.wrappers import RGBImgObsWrapper
        >>> env = RGBImgObsWrapper(mgt.make("MiniGrid-Empty-5x5-v0"), tile_size=8)
        >>> obs, _ = env.reset(2, device="cpu")
        >>> tuple(obs["image"].shape)
        (2, 40, 40, 3)
    """

    def __init__(self, env, tile_size: int = 8, highlight: bool = True):
        super().__init__(env)
        self.tile_size = tile_size
        self.highlight = highlight

    def observation(self, state, image: bool = True):
        o = self.env.observation(state, image=False)
        if not image:
            return o
        u = self.unwrapped
        img = get_frame(
            state, u.agent_view_size, u.see_through_walls, highlight=self.highlight, tile_size=self.tile_size
        )
        return {"image": img, **o}


class RGBImgPartialObsWrapper(Wrapper):
    """The agent's point of view in RGB as the image, uint8
    [N, v*ts, v*ts, 3] (reference: minigrid/wrappers.py:337-381).

    Example:
        >>> import minigrid_tpu_torch as mgt
        >>> from minigrid_tpu_torch.wrappers import RGBImgPartialObsWrapper
        >>> env = RGBImgPartialObsWrapper(mgt.make("MiniGrid-Empty-5x5-v0"), tile_size=8)
        >>> obs, _ = env.reset(2, device="cpu")
        >>> tuple(obs["image"].shape)
        (2, 56, 56, 3)
    """

    def __init__(self, env, tile_size: int = 8):
        super().__init__(env)
        self.tile_size = tile_size

    def observation(self, state, image: bool = True):
        o = self.env.observation(state, image=False)
        if not image:
            return o
        u = self.unwrapped
        img = get_frame(state, u.agent_view_size, u.see_through_walls, tile_size=self.tile_size, agent_pov=True)
        return {"image": img, **o}
