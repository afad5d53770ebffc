"""WFC subsystem (reference: minigrid/envs/wfc/); counterpart of
``minigrid_tpu/envs/wfc``."""

from minigrid_tpu_torch.envs.wfc.preprocess import WFC_PRESETS, WFCConfig
from minigrid_tpu_torch.envs.wfc.wfcenv import WFCEnv

__all__ = ["WFCEnv", "WFCConfig", "WFC_PRESETS"]
