"""The port's WFC (``minigrid_tpu_torch/envs/wfc``) against the JAX package's:
the pattern tables and their data files, the cell orders, propagation, the
solver on deterministic heuristics (grid, outcome and every counter bit for
bit), ``execute_wfc``'s stats and log lines, the largest-component filter,
and on random heuristics the legality of every solved grid and the
connectivity of ``WFCEnv``'s levels.  JAX compiles at sizes up to 12."""

from __future__ import annotations

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minigrid_tpu as mg
import minigrid_tpu_torch as mgt
from minigrid_tpu.envs.wfc import preprocess as jpre
from minigrid_tpu.envs.wfc import solver as jsolver
from minigrid_tpu.envs.wfc import wfcenv as jwfcenv
from minigrid_tpu.envs.wfc.graphtransforms import GraphTransforms as JGraphTransforms
from minigrid_tpu_torch.core.constants import OBJ_AGENT, OBJ_GOAL, OBJ_WALL, cell_type, unpack_grid
from minigrid_tpu_torch.envs.wfc import preprocess as tpre
from minigrid_tpu_torch.envs.wfc import solver as tsolver
from minigrid_tpu_torch.envs.wfc import wfcenv as twfcenv
from minigrid_tpu_torch.envs.wfc.graphtransforms import GraphTransforms as TGraphTransforms
from torch_port_util import one_torch_thread  # noqa: F401  (fixture)

PRESETS = sorted(tpre.WFC_PRESETS)


def _trap_adj():
    """tests/test_wfc.py's trap: up, right and down accept anything, but the
    only legal left neighbour of either pattern is 1, so collapsing a cell
    with a real right neighbour to pattern 0 contradicts."""
    a = np.ones((4, 2, 2), bool)
    a[3] = False
    a[3, 0, 1] = a[3, 1, 1] = True
    return a


@pytest.mark.parametrize("name", sorted(tpre.WFC_PRESETS_ALL))
def test_preset_tables_equal_jax(name):
    assert tpre.WFC_PRESETS_ALL[name].__dict__ == jpre.WFC_PRESETS_ALL[name].__dict__
    want = jpre.build_tables(jpre.WFC_PRESETS_ALL[name])
    got = tpre.build_tables(tpre.WFC_PRESETS_ALL[name])
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert tpre.DIRECTIONS == jpre.DIRECTIONS


def test_pattern_data_files_are_the_jax_package_s():
    names = sorted(os.listdir(jpre.DATA_DIR))
    assert sorted(os.listdir(tpre.DATA_DIR)) == names and len(names) == 25
    match, mismatch, errors = filecmp.cmpfiles(jpre.DATA_DIR, tpre.DATA_DIR, names, shallow=False)
    assert match == names and not mismatch and not errors


@pytest.mark.parametrize("w,h", [(1, 1), (5, 5), (9, 12), (16, 16), (23, 23), (30, 7)])
def test_cell_orders_equal_jax(w, h):
    np.testing.assert_array_equal(tsolver._spiral_order(w, h), jsolver._spiral_order(w, h))
    np.testing.assert_array_equal(tsolver._hilbert_order(w, h), jsolver._hilbert_order(w, h))


_JAX_PROPAGATE = {
    periodic: jax.jit(lambda wave, adj, periodic=periodic: jsolver._propagate(wave, adj, periodic))
    for periodic in (False, True)
}


@pytest.mark.parametrize("preset", ["MazeSimple", "DungeonMazeScaled"])
def test_propagate_equals_jax(preset):
    t = tpre.preset_tables(preset)
    periodic = tpre.WFC_PRESETS[preset].output_periodic
    p = t["adj"].shape[1]
    rng = np.random.default_rng(3)
    contradictions = 0
    for keep in (0.97, 0.9, 0.75, 0.5):
        for _ in range(3):
            wave = rng.random((p, 9, 11)) < keep
            want, want_c = _JAX_PROPAGATE[periodic](jnp.asarray(wave), jnp.asarray(t["adj"]))
            got, got_c = tsolver.propagate(torch.from_numpy(wave), t["adj"], periodic)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            assert bool(got_c) == bool(want_c)
            contradictions += bool(want_c)
    assert 0 < contradictions < 12  # both outcomes compared


def _jax_solve(adj, weights, shape, periodic, loc, backtracking=False, max_attempts=3):
    grid, ok, stats = jsolver.wfc_solve(
        jax.random.PRNGKey(0), jnp.asarray(adj), jnp.asarray(weights), jnp.zeros(shape), periodic=periodic,
        max_attempts=max_attempts, loc_heuristic=loc, choice_heuristic="lexical", backtracking=backtracking,
        with_stats=True,
    )
    return np.asarray(grid), bool(ok), {k: int(v) for k, v in stats.items()}


def _port_solve(adj, weights, shape, periodic, loc, backtracking=False, max_attempts=3):
    grid, ok, stats = tsolver.wfc_solve(
        torch.Generator().manual_seed(0), adj, weights, 2, shape, periodic, max_attempts, loc, "lexical",
        backtracking, with_stats=True,
    )
    # Deterministic heuristics: both waves of the batch are the same solve.
    assert torch.equal(grid[0], grid[1]) and bool(ok[0]) == bool(ok[1])
    return grid[0].numpy(), bool(ok[0]), {k: int(v[0]) for k, v in stats.items()}


@pytest.mark.parametrize("loc", ["lexical", "simple", "spiral", "hilbert"])
@pytest.mark.parametrize("preset,shape", [("MazeSimple", (12, 12)), ("DungeonMazeScaled", (11, 11))])
def test_deterministic_solves_equal_jax(one_torch_thread, preset, shape, loc):
    if loc in ("spiral", "hilbert"):
        order = tsolver._spiral_order(*shape) if loc == "spiral" else tsolver._hilbert_order(*shape)
        assert (order < 1.0).all()  # no cell left to the random preferences
    t = tpre.preset_tables(preset)
    periodic = tpre.WFC_PRESETS[preset].output_periodic
    want = _jax_solve(t["adj"], t["weights"], shape, periodic, loc)
    got = _port_solve(t["adj"], t["weights"], shape, periodic, loc)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


@pytest.mark.parametrize("backtracking", [False, True])
def test_backtracking_solves_equal_jax(backtracking):
    # Pattern 0 first everywhere: without backtracking every attempt
    # contradicts; with it, bans recover the solve.
    adj, weights = _trap_adj(), np.array([1e8, 1.0], np.float32)
    want = _jax_solve(adj, weights, (4, 4), False, "lexical", backtracking, max_attempts=4)
    got = _port_solve(adj, weights, (4, 4), False, "lexical", backtracking, max_attempts=4)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert want[1] == backtracking and (want[2]["backtracks"] > 0) == backtracking
    assert want[2]["contradictions"] == (0 if backtracking else 5)


def test_execute_wfc_stats_and_log_lines_equal_jax(tmp_path):
    config = tpre.WFCConfig("SimpleMaze", loc_heuristic="lexical", choice_heuristic="lexical")
    jconfig = jpre.WFCConfig("SimpleMaze", loc_heuristic="lexical", choice_heuristic="lexical")
    choices = []
    jgrid, jstats = jwfcenv.execute_wfc(
        jax.random.PRNGKey(0), jconfig, (9, 9), log_filename=str(tmp_path / "j.tsv"),
        log_stats_to_output=jwfcenv.make_log_stats(),
    )
    tgrid, tstats = twfcenv.execute_wfc(
        torch.Generator().manual_seed(0), config, (9, 9), log_filename=str(tmp_path / "t.tsv"),
        log_stats_to_output=twfcenv.make_log_stats(), on_choice=lambda *c: choices.append(c),
    )
    np.testing.assert_array_equal(tgrid, jgrid)
    assert list(tstats) == list(jstats)
    for k in jstats:
        if k != "solve duration":
            assert tstats[k] == jstats[k], k
    assert len(choices) == tstats["collapses"] == 49  # one hook call a collapse
    jlines = (tmp_path / "j.tsv").read_text().splitlines()
    tlines = (tmp_path / "t.tsv").read_text().splitlines()
    assert tlines[0] == jlines[0] and len(tlines) == len(jlines) == 2
    assert tlines[1].split("\t")[:-2] == jlines[1].split("\t")[:-2]  # all but the duration
    assert tlines[1].split("\t")[-1] == jlines[1].split("\t")[-1]


_JAX_COMPONENT = jax.jit(jax.vmap(jwfcenv._largest_component))


@pytest.mark.parametrize("shape", [(7, 7), (11, 9), (13, 13)])
def test_largest_component_equals_jax(shape):
    rng = np.random.default_rng(shape[0])
    density = rng.uniform(0.2, 0.8, (96, 1, 1))
    nav = rng.random((96,) + shape) < density
    nav[0] = False  # no component at all
    nav[1] = True  # one component, the whole grid
    nav[2] = np.indices(shape).sum(0) % 2 == 0  # singletons only
    want = np.asarray(_JAX_COMPONENT(jnp.asarray(nav)))
    got = twfcenv._largest_component(torch.from_numpy(nav)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("loc,choice", [("entropy", "weighted"), ("anti-entropy", "random"), ("random", "weighted")])
def test_solved_grids_are_adjacency_legal(one_torch_thread, loc, choice):
    t = tpre.preset_tables("MazeSimple")
    grid, ok, stats = tsolver.wfc_solve(
        torch.Generator().manual_seed(1), t["adj"], t["weights"], 16, (9, 9), False, 8, loc, choice, with_stats=True
    )
    assert int(ok.sum()) >= 12
    adj = t["adj"]
    for g, good in zip(grid.numpy(), ok.numpy()):
        if not good:
            continue
        for d, (dx, dy) in enumerate(tpre.DIRECTIONS):
            for x in range(9):
                for y in range(9):
                    if 0 <= x + dx < 9 and 0 <= y + dy < 9:
                        assert adj[d, g[x, y], g[x + dx, y + dy]]
    assert bool((stats["attempts"] == stats["contradictions"] + ok.to(torch.int32)).all())


def _reachable(t: np.ndarray, start) -> np.ndarray:
    seen = np.zeros(t.shape, bool)
    seen[start] = True
    stack = [start]
    while stack:
        x, y = stack.pop()
        for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            nb = (x + dx, y + dy)
            if 0 <= nb[0] < t.shape[0] and 0 <= nb[1] < t.shape[1] and t[nb] != OBJ_WALL and not seen[nb]:
                seen[nb] = True
                stack.append(nb)
    return seen


@pytest.mark.parametrize("preset", PRESETS)
def test_wfc_env_generates_connected_levels(one_torch_thread, preset):
    env = mgt.make(f"MiniGrid-WFC-{preset}-v0", size=13, max_attempts=32)
    assert env.expensive_reset and env.max_steps == 260 and env.mission_text() == mg.make(f"MiniGrid-WFC-{preset}-v0").mission_text()
    _, st = env.reset(8, torch.Generator().manual_seed(0), "cpu")
    types = cell_type(st.grid).numpy()
    for i, t in enumerate(types):
        assert (t == OBJ_GOAL).sum() == 1
        assert (t[0] == OBJ_WALL).all() and (t[-1] == OBJ_WALL).all() and (t[:, 0] == OBJ_WALL).all()
        assert (t[:, -1] == OBJ_WALL).all()
        assert set(np.unique(t)) <= {1, OBJ_WALL, OBJ_GOAL}
        start = (int(st.agent_x[i]), int(st.agent_y[i]))
        assert t[start] == 1
        assert _reachable(t, start)[t == OBJ_GOAL].all(), f"{preset}: goal unreachable from start"
    assert int(st.agent_dir.min()) >= 0 and int(st.agent_dir.max()) < 4


def test_graph_transforms_equal_jax():
    env = mgt.make("MiniGrid-WFC-ObstaclesBlackdots-v0", size=9)
    _, st = env.reset(3, torch.Generator().manual_seed(2), "cpu")
    encoded = unpack_grid(st.grid).numpy()
    encoded[np.arange(3), st.agent_x.numpy(), st.agent_y.numpy(), 0] = OBJ_AGENT
    for got, want in zip(TGraphTransforms.minigrid_to_bitmap(torch.from_numpy(encoded)),
                         JGraphTransforms.minigrid_to_bitmap(encoded)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    attrs = ["navigable", "non_navigable", "goal", "start"]
    from_state = TGraphTransforms.minigrid_to_dense_graph(st, node_attr=attrs)
    want = JGraphTransforms.minigrid_to_dense_graph(encoded, node_attr=attrs)
    got = TGraphTransforms.minigrid_to_dense_graph(torch.from_numpy(encoded), node_attr=attrs)
    for g0, g1, g2 in zip(from_state, got, want):
        assert dict(g0.nodes(data=True)) == dict(g1.nodes(data=True)) == dict(g2.nodes(data=True))
        np.testing.assert_array_equal(
            TGraphTransforms.dense_graph_to_minigrid(g1, (9, 9)), JGraphTransforms.dense_graph_to_minigrid(g2, (9, 9))
        )
