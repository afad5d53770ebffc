"""WFC seed parity of the port (``minigrid_tpu_torch/compat/parity_wfc.py``)
against the JAX package's (``minigrid_tpu/compat/parity_wfc.py``), which
``tests/test_seed_parity_wfc.py`` holds to the original Minigrid, on the
CPU: the reference-order pattern catalog, the host solve with its failures,
and the networkx-free replay of the reference's start/goal node order.
Parity mode solves on the host and never
reaches the solver of ``envs/wfc/solver.py`` or its kernel."""

from __future__ import annotations

import networkx  # noqa: F401  (the JAX package's node order needs it)
import numpy as np
import pytest

from minigrid_tpu.compat import parity as jparity
from minigrid_tpu.compat import parity_wfc as jwfc
from minigrid_tpu.envs.wfc.preprocess import WFC_PRESETS as JAX_PRESETS
from minigrid_tpu.envs.wfc.preprocess import WFC_PRESETS_INCONSISTENT as JAX_INCONSISTENT
from minigrid_tpu.envs.wfc.wfcenv import WFCEnv as JaxWFCEnv
from minigrid_tpu_torch.compat import parity as tparity
from minigrid_tpu_torch.compat import parity_wfc as twfc
from minigrid_tpu_torch.envs.wfc import solver as wfc_solver
from minigrid_tpu_torch.envs.wfc.preprocess import WFC_PRESETS, WFC_PRESETS_INCONSISTENT
from minigrid_tpu_torch.envs.wfc.wfcenv import WFCEnv
from minigrid_tpu_torch.ops import wfc_solve
from parity_port_util import assert_reset_parity

# The two registered presets of the reset checks (the trajectory is in
# tests/test_torch_parity_rollout.py).
RESET_IDS = ["MiniGrid-WFC-MazeSimple-v0", "MiniGrid-WFC-DungeonMazeScaled-v0"]
SEEDS = (0, 7)


@pytest.fixture
def no_solver(monkeypatch):
    """Parity mode must not reach the batched solver or its kernel: both
    raise for the test."""

    def refuse(*args, **kwargs):
        raise AssertionError("parity mode reached the batched WFC solver")

    monkeypatch.setattr(wfc_solver, "wfc_solve", refuse)
    monkeypatch.setattr(wfc_solver, "wfc_solve_reference", refuse)
    monkeypatch.setattr(wfc_solve, "wfc_solve_kernel", refuse)


@pytest.mark.parametrize("env_id", RESET_IDS)
def test_reset_parity(env_id, no_solver):
    assert_reset_parity(env_id, SEEDS)


@pytest.mark.parametrize("preset", sorted(WFC_PRESETS))
def test_catalog_parity(preset):
    """The pattern table in the reference's hash order, its weights,
    adjacency and wall patterns equal the JAX package's."""
    got = twfc._parity_tables(WFC_PRESETS[preset])
    want = jwfc._parity_tables(JAX_PRESETS[preset])
    for name, a, b in zip(("patterns", "weights", "adjacency", "walls"), got, want):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=f"{preset}: {name}")


def test_inconsistent_presets_fail_or_succeed_alike():
    """Contradiction-prone presets (the two the JAX package's test names):
    the same seed gives the same level or the same generation failure, the
    host streams in lockstep either way."""
    for name, seeds in (("MazeWall", (0, 9)), ("ObstaclesHogs2", (0, 2, 6))):
        jenv = JaxWFCEnv(wfc_config=JAX_INCONSISTENT[name], size=15)
        tenv = WFCEnv(wfc_config=WFC_PRESETS_INCONSISTENT[name], size=15)
        outcomes = set()
        for seed in seeds:
            jrng, trng = jparity._np_random(seed), tparity._np_random(seed)
            try:
                jstate = jparity.generate_with_rng(jenv, jrng, seed)
            except RuntimeError:
                jstate = None
            try:
                tstate = tparity.generate_with_rng(tenv, trng, seed, "cpu")
            except RuntimeError:
                tstate = None
            assert (tstate is None) == (jstate is None), (name, seed)
            assert trng.bit_generator.state == jrng.bit_generator.state, (name, seed)
            outcomes.add(tstate is None)
            if jstate is not None:
                np.testing.assert_array_equal(tstate.grid[0].numpy(), np.asarray(jstate.grid), err_msg=f"{name} {seed}")
                assert (int(tstate.agent_x[0]), int(tstate.agent_y[0])) == tuple(np.asarray(jstate.agent_pos))
        assert outcomes == {False, True}, "the seeds no longer cover a failure and a success"


def _random_nav(rng, r: int, c: int, density: float) -> np.ndarray:
    nav = rng.random((r, c)) < density
    # Smooth a little so that components of all sizes show up.
    nav[1:-1, 1:-1] |= nav[:-2, 1:-1] & nav[2:, 1:-1]
    return nav


def test_node_order_equals_networkx():
    """The networkx-free replay of the reference's navigable node order
    equals the JAX package's networkx calls, with and without
    ``ensure_connected``, where the largest component holds more and fewer
    than half the navigable cells (the two iteration orders of a subgraph
    view), on grids of WFC's sizes and odd shapes."""
    rng = np.random.default_rng(0)
    halves = set()
    for k in range(400):
        r, c = (int(v) for v in rng.integers(2, 24, 2))
        nav = _random_nav(rng, r, c, float(rng.uniform(0.25, 0.8)))
        for ensure in (True, False):
            try:
                want = jwfc._component_nodes(nav, ensure)
            except RuntimeError:
                with pytest.raises(RuntimeError):
                    twfc._component_nodes(nav, ensure)
                continue
            got = twfc._component_nodes(nav, ensure)
            assert got == want, (k, r, c, ensure)
            if ensure:
                halves.add(2 * len(want) < int(nav.sum()))
    assert halves == {True, False}
