"""Wrapper suite (reference: minigrid/wrappers.py, 16 wrappers), the
counterpart of ``minigrid_tpu/wrappers``, on batched states."""

from minigrid_tpu_torch.wrappers.base import Wrapper
from minigrid_tpu_torch.wrappers.control import (
    ActionBonus,
    CountingState,
    NoDeath,
    PositionBonus,
    ReseedWrapper,
    StochasticActionWrapper,
)
from minigrid_tpu_torch.wrappers.observation import (
    DictObservationSpaceWrapper,
    DirectionObsWrapper,
    FlatObsWrapper,
    FullyObsWrapper,
    ImgObsWrapper,
    OneHotPartialObsWrapper,
    SymbolicObsWrapper,
    ViewSizeWrapper,
)
from minigrid_tpu_torch.wrappers.rgb import RGBImgObsWrapper, RGBImgPartialObsWrapper

__all__ = [
    "ActionBonus",
    "CountingState",
    "DictObservationSpaceWrapper",
    "DirectionObsWrapper",
    "FlatObsWrapper",
    "FullyObsWrapper",
    "ImgObsWrapper",
    "NoDeath",
    "OneHotPartialObsWrapper",
    "PositionBonus",
    "ReseedWrapper",
    "RGBImgObsWrapper",
    "RGBImgPartialObsWrapper",
    "StochasticActionWrapper",
    "SymbolicObsWrapper",
    "ViewSizeWrapper",
    "Wrapper",
]
