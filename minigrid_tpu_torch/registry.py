"""String-id environment registry (the reference's gymnasium table,
minigrid/__init__.py:24-1135): ids map to (env class, kwargs)."""

from __future__ import annotations

from typing import Any, Callable

_REGISTRY: dict[str, tuple[Callable, dict[str, Any]]] = {}


def register(env_id: str, cls: Callable, **kwargs: Any) -> None:
    if env_id in _REGISTRY:
        raise ValueError(f"duplicate env id: {env_id}")
    _REGISTRY[env_id] = (cls, kwargs)


def make(env_id: str, **overrides: Any):
    """Instantiate a registered environment, applying kwarg overrides.

    Example:
        >>> import torch
        >>> import minigrid_tpu_torch as mgt
        >>> env = mgt.make("MiniGrid-Empty-8x8-v0")
        >>> obs, state = env.reset(4, device="cpu")
        >>> obs["image"].shape
        torch.Size([4, 7, 7, 3])
        >>> obs, state, reward, term, trunc = env.step(state, torch.full((4,), 2))
    """
    if env_id not in _REGISTRY:
        raise KeyError(f"unknown env id {env_id!r}; see minigrid_tpu_torch.registry.registered_ids()")
    cls, kwargs = _REGISTRY[env_id]
    env = cls(**{**kwargs, **overrides})
    # Stamp the id so tables keyed by registry id (parallel/reset_budget)
    # can resolve it from the instance.
    env.env_id = env_id
    return env


def registered_ids() -> list[str]:
    return sorted(_REGISTRY)


def registry_entry(env_id: str):
    """The (env class, kwargs) that ``env_id`` was registered with."""
    return _REGISTRY[env_id]
