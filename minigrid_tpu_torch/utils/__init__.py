"""Host-side utilities: oracle bot, state inspection, checkpointing.

The exports of ``minigrid_tpu/utils/__init__.py``, resolved on first use:
the core modules import submodules of this package (``utils/chunked.py``),
and the bot imports the BabyAI envs, which import the core.
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "BabyAIBot": "babyai_bot",
    "DisappearedBoxError": "babyai_bot",
    "pprint_grid": "debug",
    "state_hash": "debug",
    "save": "checkpoint",
    "load": "checkpoint",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
