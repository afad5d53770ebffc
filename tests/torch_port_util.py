"""Helpers shared by the ``test_torch_*`` files, which hold the PyTorch port
(``minigrid_tpu_torch``) against the JAX package on the same inputs.  States
cross between the two as numpy arrays (``minigrid_tpu_torch.utils.bridge``)."""

from __future__ import annotations

import jax
import numpy as np

from minigrid_tpu_torch.core.state import FIELDS
from minigrid_tpu_torch.utils.bridge import state_from_numpy, state_to_numpy


def jax_to_numpy(state) -> dict[str, np.ndarray]:
    """The port's fields of a JAX ``EnvState`` (or cache), as numpy."""
    leaves = jax.tree.map(np.asarray, state)
    return {f: getattr(leaves, f) for f in FIELDS}


def to_port(state, device="cpu"):
    return state_from_numpy(jax_to_numpy(state), device)


def assert_states_equal(port_state, jax_state, what: str = "") -> None:
    """Every field of the port's state equals the JAX state's, bit for bit."""
    got = state_to_numpy(port_state)
    want = jax_to_numpy(jax_state)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"{what}: {f}")
