"""Host-side WFC seed parity: same seed ⇒ the reference's exact level.

Counterpart of ``minigrid_tpu/compat/parity_wfc.py``, numpy only.  The
solver of ``envs/wfc/solver.py`` (the CUDA kernel on the card, its plain
version elsewhere) draws its randomness from a ``torch.Generator``, so its
levels can never coincide with the reference's numpy-PCG64 stream.  This
module is the WFC leg of parity mode (compat/parity.py), solved on the host
and never through ``ops/wfc_solve.py``: it re-derives the reference's
pattern catalog in the reference's *index order* (patterns sorted by their
deterministic content hash) and replays the exact RNG draw sequence of
``WFCEnv._gen_grid`` (reference: minigrid/envs/wfc/wfcenv.py:154-201):

1. ``choice_random_weighting`` — one uniform (H-2, W-2) array * 0.1
   (control.py:174-176), consumed by the location heuristic;
2. one ``np_random.choice(P, p=...)`` per collapse (weighted pattern
   heuristic, solver.py:320-336);
3. ``np_random.permutation(n)[:2]`` for start/goal placement
   (wfcenv.py:247-258);
4. ``integers(0, 4)`` for the agent direction (wfcenv.py:195).

Everything in between (constraint propagation, entropy argmin, connected
components) is deterministic and mirrored cell-for-cell.  The JAX package's
twin is verified live against the reference in
tests/test_seed_parity_wfc.py; this one is held to it bit for bit in
tests/test_torch_parity_wfc.py.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np

from minigrid_tpu_torch.envs.wfc.preprocess import (
    DATA_DIR,
    DIRECTIONS,
    WFCConfig,
    legal_adjacency,
)


class _Contradiction(Exception):
    """A wave cell lost its last candidate (reference solver.py:19-22)."""


# ---------------------------------------------------------------------------
# Reference-order pattern catalog
# ---------------------------------------------------------------------------


def _hash_vec(n: int) -> np.ndarray:
    """The reference's deterministic content-hash weights: hash(x) = <x, v>
    over int64 wraparound arithmetic with v drawn from a fixed
    RandomState(0) (reference utilities.py:16-24).  Pattern *index order* in
    the reference is ascending hash order, which is why parity must use the
    same hash."""
    return np.random.RandomState(0).randint(1 - (1 << 63), 1 << 63, n, dtype=np.int64)


def _dihedral_passes(grid: np.ndarray, passes: int):
    """The reference's cumulative identity/reflect/rotate orientation chain
    (patterns.py:148-169); ``rotations=8`` in the config means 8 passes."""
    ops = ("id", "refl", "rot", "refl", "rot", "refl", "rot", "refl")
    g = grid
    for i in range(passes):
        if ops[i] == "refl":
            g = np.fliplr(g)
        elif ops[i] == "rot":
            g = np.rot90(g, axes=(1, 0))
        yield g


@lru_cache(maxsize=None)
def _parity_tables(config: WFCConfig):
    """Pattern table in the reference's encode order.

    Returns (pats [P,k,k] int64 tile hashes sorted by pattern hash,
    weights float64[P] per-orientation-pass presence counts,
    adj bool[4,P,P], wall_pattern bool[P]).

    Mirrors make_tile_catalog (tiles.py:33-64),
    make_pattern_catalog_with_rotations (patterns.py:117-179) and
    adjacency_extraction (adjacency.py:8-56); the reference's
    ``encode_patterns`` maps pattern hash -> index in the np.unique-sorted
    merged hash list (control.py:136-137), i.e. ascending hash order.
    """
    with np.load(os.path.join(DATA_DIR, config.pattern + ".npz")) as z:
        tile_grid = z["tile_grid"]
        colors = z["colors"].astype(np.int64)
    assert config.tile_size == 1
    k = config.pattern_width

    # Tile hash = <rgb, v3>; for tile_size=1 each pixel is its own tile.
    v3 = _hash_vec(3)
    with np.errstate(over="ignore"):
        tile_hashes_by_color = colors @ v3  # int64 wraparound, like np.inner
    tile_hash_grid = tile_hashes_by_color[tile_grid]

    # A cell becomes a wall iff its pixel's *red channel* is 0 — the
    # reference compares the full RGB against black but then keeps only
    # channel 0 of the match (wfcenv.py:203-214).
    wall_hashes = set(tile_hashes_by_color[colors[:, 0] == 0].tolist())

    vk = _hash_vec(k * k)
    contents: dict[int, np.ndarray] = {}
    presence: dict[int, int] = {}
    for g in _dihedral_passes(tile_hash_grid, config.rotations):
        padded = np.pad(g, ((0, k - 1), (0, k - 1)), mode="wrap")
        win = np.lib.stride_tricks.sliding_window_view(padded, (k, k))
        win = win.reshape(-1, k, k)
        with np.errstate(over="ignore"):
            codes = win.reshape(-1, k * k) @ vk
        uniq, first = np.unique(codes, return_index=True)
        for h, idx in zip(uniq.tolist(), first.tolist()):
            contents[h] = win[idx]
            presence[h] = presence.get(h, 0) + 1

    hashes = sorted(contents)  # == np.unique merge order (patterns.py:141-144)
    pats = np.stack([contents[h] for h in hashes])
    weights = np.array([presence[h] for h in hashes], dtype=np.float64)
    adj = legal_adjacency(pats)
    wall_pattern = np.array([int(contents[h][0, 0]) in wall_hashes for h in hashes])
    return pats, weights, adj, wall_pattern


# ---------------------------------------------------------------------------
# Solver replay (reference solver.py:37-118, 421-530)
# ---------------------------------------------------------------------------


def _propagate(wave: np.ndarray, adj: np.ndarray, periodic: bool) -> None:
    """Fixed-point constraint propagation, in place (solver.py:421-483):
    per sweep, a pattern survives at a cell iff each of its four neighbors
    still admits some legal partner; sweeps until the support count stops
    changing, then raises on any empty cell."""
    P, R, C = wave.shape
    last = wave.sum()
    while True:
        if periodic:
            padded = np.pad(wave, ((0, 0), (1, 1), (1, 1)), mode="wrap")
        else:
            padded = np.pad(
                wave, ((0, 0), (1, 1), (1, 1)), mode="constant", constant_values=True
            )
        for di, (dx, dy) in enumerate(DIRECTIONS):
            shifted = padded[:, 1 + dx : 1 + R + dx, 1 + dy : 1 + C + dy]
            wave &= (adj[di] @ shifted.reshape(P, -1)).reshape(P, R, C)
        count = wave.sum()
        if count == last:
            break
        last = count
    if (~wave.any(axis=0)).any():
        raise _Contradiction


def _spiral_ranks(noise: np.ndarray) -> np.ndarray:
    """The reference's center-out spiral cell order (solver.py:211-252),
    including fill_with_curve's quirks: negative spiral coordinates *wrap*
    (numpy negative indexing — only true IndexErrors are skipped) and cells
    the spiral never reaches keep their noise value, because the reference
    mutates the preference array in place."""
    order = noise.copy()
    R, C = order.shape
    x, y = R // 2, C // 2
    fill, total = 0, R * C

    def visit(i, j):
        nonlocal fill
        if fill < total and -R <= i < R and -C <= j < C:
            order[i, j] = fill / total
            fill += 1

    visit(x, y)
    n = 1
    while fill < total:
        if n % 2 == 0:
            steps = [(0, 1)] + [(1, 0)] * n + [(0, -1)] * n
        else:
            steps = [(0, -1)] + [(-1, 0)] * n + [(0, 1)] * n
        for di, dj in steps:
            x += di
            y += dj
            visit(x, y)
        n += 1
    return order


def _make_location_fn(loc: str, noise: np.ndarray):
    """Location heuristics (solver.py:152-305).  All resolve ties through a
    row-major argmin/argmax over the same preference array the reference
    builds, so the chosen cell matches index-for-index."""
    if loc == "hilbert":  # same failure mode as the reference (no package)
        raise ImportError("hilbertcurve is not installed")
    if loc == "spiral":
        noise = _spiral_ranks(noise)

    def location(wave: np.ndarray):
        counts = np.count_nonzero(wave, axis=0)
        unresolved = counts > 1
        if loc == "entropy":
            cw = np.where(unresolved, noise + counts, np.inf)
        elif loc == "anti-entropy":
            cw = np.where(unresolved, noise + counts, -np.inf)
            return np.unravel_index(np.argmax(cw), cw.shape)
        elif loc == "simple":
            cw = np.where(unresolved, counts, np.inf)
        elif loc == "lexical":
            cw = np.where(unresolved, 1.0, np.inf)
        elif loc in ("random", "spiral"):
            cw = np.where(unresolved, noise, np.inf)
        else:
            raise ValueError(f"unknown location heuristic {loc!r}")
        return np.unravel_index(np.argmin(cw), cw.shape)

    return location


def _make_pattern_fn(choice: str, weights: np.ndarray, rng: np.random.Generator):
    """Pattern heuristics (solver.py:316-406), consuming ``rng`` exactly
    like the reference's factories (one ``choice`` per collapse)."""
    P = len(weights)

    def pattern(cell_wave: np.ndarray, wave: np.ndarray) -> int:
        if choice == "weighted":
            p = weights * cell_wave
            return int(rng.choice(P, p=p / p.sum()))
        if choice == "random":
            p = 1.0 * cell_wave
            return int(rng.choice(P, p=p / p.sum()))
        if choice == "rarest":
            # Reference quirk preserved: picks among the *globally* most
            # available patterns, ignoring the cell's own candidates
            # (solver.py:339-361).
            sums = wave.sum(axis=(1, 2))
            return int(rng.choice(np.where(sums == sums.max())[0]))
        if choice == "lexical":
            return int(np.nonzero(cell_wave)[0][0])
        raise ValueError(f"unknown choice heuristic {choice!r}")

    return pattern


def _solve(rng: np.random.Generator, config: WFCConfig, R: int, C: int):
    """One reference solve attempt.  Returns bool[R, C] wall mask or raises
    RuntimeError — the reference's attempt loop returns after its first
    attempt regardless of the limit (control.py:230-283 returns inside the
    while), and WFCEnv raises on a None pattern (wfcenv.py:165-168)."""
    _, weights, adj, wall_pattern = _parity_tables(config)
    P = len(weights)
    wave = np.ones((P, R, C), dtype=bool)
    noise = rng.random((R, C)) * 0.1  # control.py:174-176
    location = _make_location_fn(config.loc_heuristic, noise)
    pattern_of = _make_pattern_fn(config.choice_heuristic, weights, rng)

    def is_solved():
        return wave.sum() == R * C and (wave.sum(axis=0) == 1).all()

    history: list[np.ndarray] = []
    try:
        # Solver.solve_next loop (solver.py:72-118): entry propagate is
        # outside the backtracking try, so a contradiction it raises after a
        # ban aborts the whole attempt, exactly like the reference.
        while not is_solved():
            if config.backtracking:
                history.append(wave.copy())
            _propagate(wave, adj, config.output_periodic)
            pattern = i = j = None
            try:
                i, j = location(wave)
                pattern = pattern_of(wave[:, i, j], wave)
                wave[:, i, j] = False
                wave[pattern, i, j] = True
                _propagate(wave, adj, config.output_periodic)
            except _Contradiction:
                if not config.backtracking or not history:
                    raise
                wave = history.pop()
                wave[pattern, i, j] = False
    except _Contradiction:
        raise RuntimeError(
            "Could not generate a valid pattern within the attempt limit"
        ) from None

    return wall_pattern[np.argmax(wave, axis=0)]


# ---------------------------------------------------------------------------
# Graph stage + parity generator (wfcenv.py:170-201, graphtransforms.py)
# ---------------------------------------------------------------------------


def _component_nodes(nav: np.ndarray, ensure_connected: bool) -> list:
    """The reference's navigable node list in ITS iteration order.

    The node order that feeds ``np_random.permutation`` is not row-major: the
    reference funnels the largest component through
    ``graph.subgraph(component)`` (wfcenv.py:216-245), a networkx view over a
    node *set*, whose iteration order is set order.  The JAX package replays
    that call sequence through networkx, which is no dependency of this
    package: this function replays the same operations on the same Python
    dicts and sets that networkx 3.x performs (a set's order follows
    from the sequence of insertions into it, which is replayed exactly):
    graphtransforms.py:164-179's graph (nodes sorted row-major, 4-neighbor
    edges between navigable cells, added in ``grid_2d_graph``'s edge
    order), ``connected_components``' BFS sets, ``subgraph(c).copy()`` and
    the final subgraph view, whose iteration takes the filter's set when it
    holds fewer than half the graph's nodes (``FilterAtlas.__iter__``) and
    the graph's row-major order otherwise.
    ``tests/test_torch_parity_wfc.py`` holds it to networkx."""
    R, C = nav.shape
    rows = [(r, c) for r in range(R) for c in range(C)]
    navigable = [n for n in rows if nav[n]]
    if not ensure_connected:
        return navigable

    # grid_2d_graph(R, C): edges to the row before, then to the column before.
    grid: dict = {n: {} for n in rows}
    for i in range(1, R):
        for j in range(C):
            grid[(i, j)][(i - 1, j)] = grid[(i - 1, j)][(i, j)] = True
    for i in range(R):
        for j in range(1, C):
            grid[(i, j)][(i, j - 1)] = grid[(i, j - 1)][(i, j)] = True
    for n in rows:  # remove_nodes_from(the walls)
        if not nav[n]:
            for u in list(grid[n]):
                del grid[u][n]
            del grid[n]
    # g.add_edges_from(grid.edges): EdgeView yields each edge once, from the
    # first of its ends in node order; the walls have no edges, so removing
    # them from g leaves the navigable nodes in row-major order.
    adj: dict = {n: {} for n in navigable}
    done: set = set()
    for n, nbrs in grid.items():
        for nbr in list(nbrs):
            if nbr not in done:
                adj[n][nbr] = adj[nbr][n] = True
        done.add(n)

    # connected_components: one _plain_bfs set per unseen node, in order.
    total, seen, components = len(adj), set(), []
    for v in adj:
        if v in seen:
            continue
        comp, nextlevel = {v}, [v]
        while nextlevel:
            thislevel, nextlevel = nextlevel, []
            for u in thislevel:
                for w in adj[u]:
                    if w not in comp:
                        comp.add(w)
                        nextlevel.append(w)
                if len(comp) == total - len(seen):
                    break
            else:
                continue
            break
        seen.update(comp)
        components.append(comp)
    components = [c for c in sorted(components, key=len, reverse=True) if len(c) > 1]
    if not components:
        raise RuntimeError("no navigable component of size > 1")

    def view_order(nodes) -> list:
        """Iteration order of ``graph.subgraph(nodes)``'s nodes."""
        shown = set(n for n in nodes if n in adj)  # show_nodes(nbunch_iter(nodes))
        if 2 * len(shown) < total:
            return [n for n in shown if n in adj]
        return [n for n in adj if n in shown]

    # g.subgraph(components[0].copy()): the copy holds the view's order.
    return view_order(view_order(components[0]))


def gen_wfc(env, b) -> dict:
    """Parity generator for WFCEnv, registered in PARITY_GENERATORS.

    Replays WFCEnv._gen_grid's draw order (wfcenv.py:154-201) onto the
    HostBuilder's packed grid; the start cell stays empty because the
    reference's Grid.decode drops the agent marker (world_object.py:77-78).
    """
    from minigrid_tpu_torch.compat.parity import P_GOAL, P_WALL
    from minigrid_tpu_torch.envs.wfc.wfcenv import _MISSION

    size = env.width
    R = C = size - 2
    wall = _solve(b.rng, env.config, R, C)
    nav = ~wall

    # Start/goal: permutation over the navigable nodes in the reference's
    # own (networkx) iteration order (wfcenv.py:247-258).
    nodes = _component_nodes(nav, env.ensure_connected)
    inds = b.rng.permutation(len(nodes))[:2]
    start, goal = nodes[inds[0]], nodes[inds[1]]
    keep = np.zeros((R, C), dtype=bool)
    keep[tuple(np.array(nodes).T)] = True

    # grid_array axis 0 is decoded as minigrid x (grid.py Grid.decode), so
    # wave row i / col j land at cell (x=i+1, y=j+1) inside the wall border.
    b.wall_rect(0, 0, size, size)
    for r in range(R):
        for c in range(C):
            if not keep[r, c]:
                b.set(r + 1, c + 1, P_WALL)
    b.set(goal[0] + 1, goal[1] + 1, P_GOAL)
    b.agent_pos = (start[0] + 1, start[1] + 1)
    b.agent_dir = b.rand_int(0, 4)

    return {
        "complete": True,
        "mission": _MISSION.numpy(),
        "max_steps": env.max_steps,
    }
