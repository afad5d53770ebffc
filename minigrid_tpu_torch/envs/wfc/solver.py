"""Batched Wave Function Collapse solver.

Counterpart of ``minigrid_tpu/envs/wfc/solver.py``, whose ``wfc_solve``
solves one wave in a jitted ``while_loop`` and is ``vmap``ped over keys.
Here one call solves N independent waves, each with JAX's per-wave
semantics (reference: minigrid/envs/wfc/wfclogic/solver.py:37-529): on the
card in the CUDA kernel ``ops/wfc_solve.py`` (a thread block a wave), on
the CPU in the plain version ``wfc_solve_reference``, in lockstep:

* the wave is held pattern-major, bool[P, N, W, H], so that one sweep of
  constraint propagation is one (4P, P) @ (P, N * (W+2) * (H+2)) product of
  the four directions' adjacency with the padded wave (0/1 operands, so a
  float16 product on CUDA and a float32 one on the CPU are exact), four
  shifted compares and an AND;
* propagation runs to the fixed point of every wave: the operator only
  removes patterns, so a sweep on a wave at its fixed point changes
  nothing, and the batch sweeps until no wave changed, checked on the host
  every ``PROPAGATE_CHECK`` sweeps;
* every wave takes its own collapse steps (location heuristic, pattern
  heuristic, collapse, propagation, backtracking) under its own loop
  condition, evaluated on the device at every step; the host looks every
  ``SYNC_EVERY`` steps, records the attempts that ended, restarts the
  failed ones (up to ``max_attempts``) and drops the finished waves from
  the working batch.

Feature parity with the reference (and the JAX package): location
heuristics ``entropy``, ``anti-entropy``, ``random``, ``simple``,
``lexical``, ``spiral``, ``hilbert`` (solver.py:167-305); pattern
heuristics ``weighted``, ``random``, ``lexical``, ``rarest``,
``most-common`` (solver.py:316-406; rarest and most-common pick from the
global possibility counts, not masked by the chosen cell's domain, as the
reference does); single-snapshot backtracking, where a ban that
contradicts fails the attempt (solver.py:85-112); contradiction restarts;
the per-attempt preference redraw and the 4 * W * H step cap of the JAX
package; the counters ``attempts``, ``collapses``, ``backtracks`` and
``contradictions``.  Each wave's seed comes from the caller's
``torch.Generator`` and every draw is a Threefry word of it
(``ops/prng.py``), so the kernel and the plain version agree on every
heuristic; the deterministic ones (location ``lexical``, ``simple``,
``spiral`` and ``hilbert`` on grids the curve covers, pattern ``lexical``)
give JAX's results bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from minigrid_tpu_torch.core.state import resolve_device
from minigrid_tpu_torch.ops import wfc_solve as wfc_kernel
from minigrid_tpu_torch.ops.prng import draw_seeds, threefry2x32

LOC_HEURISTICS = (
    "entropy",
    "anti-entropy",
    "random",
    "simple",
    "lexical",
    "spiral",
    "hilbert",
)
CHOICE_HEURISTICS = ("weighted", "random", "lexical", "rarest", "most-common")
_DIRECTIONS = ((0, -1), (1, 0), (0, 1), (-1, 0))

# Sweeps between the host's fixed-point checks, and collapse steps between
# its looks at the batch (attempts ended, restarts, finished waves).
PROPAGATE_CHECK = 2
SYNC_EVERY = 4
# Counter word of a cell's preference draw: (attempt, PREF_COUNTER | cell);
# a pattern choice draws (attempt, step).
PREF_COUNTER = 0x40000000
# Host syncs made by the plain version since import (each check above, and the
# bookkeeping of a look): read by chip_smoke.py.
HOST_SYNCS = 0


def _spiral_order(w: int, h: int) -> np.ndarray:
    """Cell-visit order of the reference's square spiral from the center
    (solver.py:212-240): for each ring, one step then N steps down / left /
    N up / right, alternating.  Out-of-range coordinates: negative indices
    wrap (numpy indexing), too-large ones are skipped — both mirrored.
    Returns float order values in [0, 1); unvisited cells keep 2.0."""
    order = np.full((w, h), 2.0)
    total = w * h
    fill = 0

    def visit(x, y):
        nonlocal fill
        if fill >= total:
            return
        if x >= w or y >= h or x < -w or y < -h:
            return
        order[x, y] = fill / total
        fill += 1

    x, y = w // 2, h // 2
    visit(x, y)
    n = 1
    while fill < total and n < 4 * (w + h):
        if n % 2 == 0:
            steps = [(0, 1)] + [(1, 0)] * n + [(0, -1)] * n
        else:
            steps = [(0, -1)] + [(-1, 0)] * n + [(0, 1)] * n
        for dx, dy in steps:
            x += dx
            y += dy
            visit(x, y)
        n += 1
    return order


def _hilbert_order(w: int, h: int) -> np.ndarray:
    """Hilbert-curve visit order (reference solver.py:276-295; it hardcodes a
    16x16 curve regardless of grid size — cells beyond the curve keep their
    random preference values, mirrored by returning 2.0 there)."""
    side = 16  # curve_size = 4 iterations, 2**4 per side (solver.py:283)
    order = np.full((w, h), 2.0)
    total = w * h

    def d2xy(n, d):
        # Standard Hilbert d->(x, y) (public-domain algorithm).
        rx = ry = 0
        x = y = 0
        t = d
        s = 1
        while s < n:
            rx = 1 & (t // 2)
            ry = 1 & (t ^ rx)
            if ry == 0:
                if rx == 1:
                    x, y = s - 1 - x, s - 1 - y
                x, y = y, x
            x += s * rx
            y += s * ry
            t //= 4
            s *= 2
        return x, y

    fill = 0
    for d in range(side * side):
        x, y = d2xy(side, d)
        if x < w and y < h and fill < total:
            order[x, y] = fill / total
            fill += 1
    return order


def _synced(flag: torch.Tensor) -> bool:
    """A device flag read on the host (counted in ``HOST_SYNCS``)."""
    global HOST_SYNCS
    HOST_SYNCS += 1
    return bool(flag)


def support_operand(adj, device) -> torch.Tensor:
    """The four directions' adjacency bool[4, P, P] as one (4P, P) product
    operand: row d*P + p, column q set where q may sit in direction d of p.
    float16 on CUDA, float32 elsewhere; either is exact on 0/1 values."""
    adj = torch.as_tensor(np.asarray(adj) if not isinstance(adj, torch.Tensor) else adj, device=device)
    dtype = torch.float16 if torch.device(device).type == "cuda" else torch.float32
    return adj.reshape(-1, adj.shape[-1]).to(dtype)


def _sweep(wave: torch.Tensor, operand: torch.Tensor, periodic: bool) -> torch.Tensor:
    """One sweep of support constraints over a pattern-major wave
    bool[P, N, W, H] (reference solver.py:421-483): a pattern stays where,
    in every direction, the neighbouring cell (the padding: any pattern, or
    the wrapped cell if periodic) holds a pattern it may sit beside."""
    p, n, w, h = wave.shape
    x = wave.to(operand.dtype)
    padded = F.pad(x, (1, 1, 1, 1), mode="circular") if periodic else F.pad(x, (1, 1, 1, 1), value=1.0)
    out = (operand @ padded.reshape(p, -1)).reshape(4, p, n, w + 2, h + 2)
    new = wave
    for d, (dx, dy) in enumerate(_DIRECTIONS):
        new = new & (out[d, :, :, 1 + dx : 1 + w + dx, 1 + dy : 1 + h + dy] > 0)
    return new


def _propagate(wave: torch.Tensor, operand: torch.Tensor, periodic: bool):
    """Every wave of a pattern-major bool[P, N, W, H] batch at its fixed
    point; returns (wave, contradiction bool[N]: a cell with no pattern
    left).  Each wave equals JAX's ``_propagate`` of it alone."""
    while True:
        before = wave
        for _ in range(PROPAGATE_CHECK):
            wave = _sweep(wave, operand, periodic)
        if not _synced((wave != before).any()):
            break
    return wave, ~wave.any(dim=0).flatten(1).all(dim=1)


def propagate(wave, adj, periodic: bool):
    """The fixed point of one wave bool[P, W, H] (JAX's ``_propagate``
    signature): returns (wave, contradiction)."""
    wave = torch.as_tensor(wave)
    new, contradiction = _propagate(wave[:, None], support_operand(adj, wave.device), periodic)
    return new[:, 0], contradiction[0]


def _static_order(loc_heuristic: str, w: int, h: int, device):
    if loc_heuristic == "spiral":
        order = _spiral_order(w, h)
    elif loc_heuristic == "hilbert":
        order = _hilbert_order(w, h)
    elif loc_heuristic == "lexical":
        # Constant score; argmin tie-breaks to the first flat index, matching
        # the reference's unravel(argmin(ones)) (solver.py:306-311).
        order = np.ones((w, h))
    else:
        return None
    return torch.as_tensor(order.astype(np.float32), device=device)


def _draw_prefs(seeds, attempt, w: int, h: int, static_order, loc_heuristic: str):
    """Each wave's cell preferences for its attempt ``attempt`` (int32[n]),
    float32[n, W, H]: uniform * 0.1 from the words (attempt,
    ``PREF_COUNTER`` | cell) of the wave's stream, or the static order
    (cells beyond a curve keep the random values)."""
    n = seeds.shape[0]
    if loc_heuristic in ("lexical", "simple"):
        # The simple heuristic reads no preferences.
        fill = static_order if static_order is not None else torch.zeros((w, h), device=seeds.device)
        return fill.expand(n, w, h).clone()
    cells = torch.arange(w * h, dtype=torch.int64, device=seeds.device)
    bits, _ = threefry2x32(seeds[:, :1], seeds[:, 1:], attempt[:, None], PREF_COUNTER | cells[None, :])
    u = (bits >> 8).to(torch.float32) * 2.0**-24
    rand = (u * torch.tensor(0.1, dtype=torch.float32, device=seeds.device)).reshape(n, w, h)
    if static_order is None:
        return rand
    return torch.where(static_order > 1.5, rand, static_order)


def _uniform53(seeds, attempt, step) -> torch.Tensor:
    """float64[n] uniform in [0, 1) from the words (attempt, step) of each
    wave's stream: 53 bits of the two words."""
    w0, w1 = threefry2x32(seeds[:, 0], seeds[:, 1], attempt, step)
    return ((w0 >> 5) * 2**26 + (w1 >> 6)).to(torch.float64) * 2.0**-53


def _choose_location(counts: torch.Tensor, prefs: torch.Tensor, loc_heuristic: str) -> torch.Tensor:
    """Flat cell index (int64[N]) of each wave's next collapse: an
    arg-extreme over the unresolved cells of a per-cell score (the first
    one on ties, as ``jnp.argmin`` / ``argmax``)."""
    unresolved = counts > 1
    if loc_heuristic in ("entropy", "anti-entropy"):
        base = prefs + counts
    elif loc_heuristic == "simple":
        base = counts.to(torch.float32)
    else:  # random / lexical / spiral / hilbert: the preferences
        base = prefs
    if loc_heuristic == "anti-entropy":
        return torch.where(unresolved, base, -torch.inf).flatten(1).argmax(dim=1)
    return torch.where(unresolved, base, torch.inf).flatten(1).argmin(dim=1)


def _categorical(u: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """One index per row of float probs [N, P] (not normalised) for the
    uniform ``u`` float64[N]: the first index whose cumulative sum (float64)
    exceeds u times the total; an entry of probability 0 is never drawn."""
    c = probs.to(torch.float64).cumsum(dim=1)
    idx = torch.searchsorted(c, (u * c[:, -1])[:, None], right=True)[:, 0]
    last = probs.shape[1] - 1 - (probs > 0).flip(1).to(torch.uint8).argmax(dim=1)
    return torch.minimum(idx, last)


def _choose_pattern(u, wave, cell, weights, choice_heuristic: str) -> torch.Tensor:
    """Each wave's pattern (int64[N]) for its chosen cell, whose domain is
    ``cell`` bool[N, P] (reference solver.py:316-406)."""
    if choice_heuristic == "weighted":
        return _categorical(u, weights * cell)
    if choice_heuristic == "random":
        return _categorical(u, cell.to(torch.float32))
    if choice_heuristic == "lexical":
        # First possible pattern (solver.py:316-318).
        return cell.to(torch.uint8).argmax(dim=1)
    # rarest / most-common: global possibility counts, NOT masked by the
    # cell's domain (reference solver.py:384-406), with the JAX package's
    # targets (the maximum for rarest, the minimum for most-common).
    sums = wave.flatten(2).sum(dim=2, dtype=torch.int32).T
    target = sums.amax(dim=1) if choice_heuristic == "rarest" else sums.amin(dim=1)
    return _categorical(u, (sums == target[:, None]).to(torch.float32))


def wfc_solve(
    generator: torch.Generator | None,
    adj,
    weights,
    num_waves: int,
    shape: tuple[int, int],
    periodic: bool,
    max_attempts: int = 64,
    loc_heuristic: str = "entropy",
    choice_heuristic: str = "weighted",
    backtracking: bool = False,
    with_stats: bool = False,
    on_choice=None,
    on_observe=None,
    on_propagate=None,
    on_backtrack=None,
    device=None,
    plain: bool = False,
):
    """Solve ``num_waves`` independent waves of ``shape`` (W, H) over the
    patterns of ``adj`` (bool[4, P, P]) and ``weights`` (float32[P]), on
    ``device`` (else the generator's, else CUDA): each wave's seed is drawn
    from ``generator``, then the CUDA kernel (``ops/wfc_solve.py``) solves
    them on the card and the plain version (``wfc_solve_reference``) on the
    CPU, or anywhere with ``plain=True``.

    Returns (pattern grids int32[N, W, H], ok bool[N]) or, with
    ``with_stats=True``, (grids, ok, stats) with stats a dict of int32[N]
    tensors: attempts, collapses, backtracks, contradictions.  A wave that
    ends without success keeps its last attempt's grid (the first possible
    pattern of each cell, 0 where none is left), as in the JAX package.

    ``on_choice(pattern, i, j)`` / ``on_observe(wave)`` / ``on_propagate(wave)``
    / ``on_backtrack()`` mirror the reference Solver's event hooks
    (solver.py:47-51), with the wave bool[P, W, H]; they need
    ``num_waves=1`` and the plain version, where they are Python calls
    between steps."""
    if loc_heuristic not in LOC_HEURISTICS:
        raise NotImplementedError(f"loc_heuristic={loc_heuristic!r}")
    if choice_heuristic not in CHOICE_HEURISTICS:
        raise NotImplementedError(f"choice_heuristic={choice_heuristic!r}")
    hooks = (on_choice, on_observe, on_propagate, on_backtrack)
    device = resolve_device(generator, device)
    w, h = shape
    seeds = draw_seeds(generator, int(num_waves), device)
    if device.type == "cpu" or plain:
        adj = torch.as_tensor(np.asarray(adj) if not isinstance(adj, torch.Tensor) else adj, device=device)
        weights = torch.as_tensor(np.asarray(weights, np.float32) if not isinstance(weights, torch.Tensor) else weights)
        weights = weights.to(device=device, dtype=torch.float32)
        grid, ok, stats = wfc_solve_reference(
            seeds, adj, weights, shape, periodic, max_attempts, loc_heuristic, choice_heuristic, backtracking, *hooks
        )
    else:
        # The kernel's wrapper reads adj on the host and keeps its tables on
        # the card.
        if any(f is not None for f in hooks):
            raise ValueError("the event hooks run in the plain version: pass plain=True")
        order = _static_order(loc_heuristic, w, h, device) if loc_heuristic in ("spiral", "hilbert") else None
        grid, ok, stats = wfc_kernel.wfc_solve_kernel(
            seeds, adj, weights, order, shape, periodic, max_attempts, loc_heuristic, choice_heuristic, backtracking
        )
    return (grid, ok, stats) if with_stats else (grid, ok)


def wfc_solve_reference(
    seeds: torch.Tensor,
    adj: torch.Tensor,
    weights: torch.Tensor,
    shape: tuple[int, int],
    periodic: bool,
    max_attempts: int,
    loc_heuristic: str,
    choice_heuristic: str,
    backtracking: bool,
    on_choice=None,
    on_observe=None,
    on_propagate=None,
    on_backtrack=None,
):
    """The plain version of the kernel: one wave per row of ``seeds`` (int32
    [N, 2]), solved in lockstep on the seeds' device.  Every wave takes its
    own collapse steps under its own loop condition, evaluated on the device
    at every step; the host looks every ``SYNC_EVERY`` steps, records the
    attempts that ended, restarts the failed ones and drops the finished
    waves from the working batch.  Returns (grids, ok, stats)."""
    global HOST_SYNCS
    device = seeds.device
    n = seeds.shape[0]
    hooks = any(f is not None for f in (on_choice, on_observe, on_propagate, on_backtrack))
    if hooks and n != 1:
        raise ValueError(f"the event hooks need num_waves=1, got {n}")
    w, h = shape
    operand = support_operand(adj, device)
    p = operand.shape[1]
    max_steps = 4 * w * h  # bounded-compute cap (the reference loops freely)
    static_order = _static_order(loc_heuristic, w, h, device)

    grid = torch.zeros((n, w, h), dtype=torch.int32, device=device)
    ok = torch.zeros(n, dtype=torch.bool, device=device)
    attempts, collapses, backtracks, contradictions = (
        torch.zeros(n, dtype=torch.int32, device=device) for _ in range(4)
    )
    # Every attempt starts from the propagated all-True wave.
    wave0, failed0 = _propagate(torch.ones((p, 1, w, h), dtype=torch.bool, device=device), operand, periodic)

    # The working batch: global lane ids and each lane's attempt state.
    lanes = torch.arange(n, device=device)
    wave = wave0.expand(p, n, w, h).contiguous()
    failed = failed0.expand(n).clone()
    steps = torch.zeros(n, dtype=torch.int32, device=device)
    att_collapses = torch.zeros(n, dtype=torch.int32, device=device)
    att_backtracks = torch.zeros(n, dtype=torch.int32, device=device)
    prefs = _draw_prefs(seeds, attempts, w, h, static_order, loc_heuristic)

    def running(counts):
        solved = (counts == 1).flatten(1).all(dim=1)
        return ~solved & ~failed & (steps < max_steps)

    while lanes.numel():
        m = lanes.numel()
        rows = torch.arange(m, device=device)
        lane_seeds, lane_attempt = seeds[lanes], attempts[lanes]
        for _ in range(SYNC_EVERY):
            counts = wave.sum(dim=0, dtype=torch.int32)
            active = running(counts)
            if hooks and not _synced(active[0]):
                break
            flat = _choose_location(counts, prefs, loc_heuristic)
            flat_wave = wave.reshape(p, m, w * h)
            cell = flat_wave[:, rows, flat].T
            u = _uniform53(lane_seeds, lane_attempt, steps)
            pattern = _choose_pattern(u, wave, cell, weights, choice_heuristic)
            onehot = torch.arange(p, device=device)[:, None] == pattern[None, :]
            collapsed = flat_wave.clone()
            collapsed[:, rows, flat] = torch.where(active[None, :], onehot, cell.T)
            collapsed = collapsed.reshape(p, m, w, h)
            if on_choice is not None:
                on_choice(int(pattern[0]), int(flat[0]) // h, int(flat[0]) % h)
            if on_observe is not None:
                on_observe(collapsed[:, 0])
            new, contradiction = _propagate(collapsed, operand, periodic)
            if on_propagate is not None:
                on_propagate(new[:, 0])
            contradiction = contradiction & active
            if backtracking:
                att_backtracks += contradiction.to(torch.int32)
            if backtracking and _synced(contradiction.any()):
                # Pop the entry snapshot and ban the choice (solver.py:103-112);
                # the ban's own contradiction fails the attempt (:85-87).  A
                # wave without a contradiction is at its fixed point already.
                if on_backtrack is not None:
                    on_backtrack()
                banned = flat_wave.clone()
                banned[pattern, rows, flat] &= ~contradiction
                source = torch.where(contradiction[None, :, None, None], banned.reshape(p, m, w, h), new)
                new, contradiction = _propagate(source, operand, periodic)
            wave = new
            failed = torch.where(active, contradiction, failed)
            steps += active.to(torch.int32)
            att_collapses += active.to(torch.int32)

        # The host's look: record the attempts that ended, restart the
        # failed ones, drop the finished waves.
        counts = wave.sum(dim=0, dtype=torch.int32)
        ended = ~running(counts)
        if not _synced(ended.any()):
            continue
        sel = ended.nonzero()[:, 0]
        ids = lanes[sel]
        success = (counts[sel] == 1).flatten(1).all(dim=1) & ~failed[sel]
        grid[ids] = wave[:, sel].to(torch.uint8).argmax(dim=0).to(torch.int32)
        ok[ids] = success
        attempts[ids] += 1
        collapses[ids] += att_collapses[sel]
        backtracks[ids] += att_backtracks[sel]
        contradictions[ids] += (~success).to(torch.int32)
        finished = torch.zeros(m, dtype=torch.bool, device=device)
        finished[sel] = success | (attempts[ids] > max_attempts)
        restart = sel[~finished[sel]]
        keep = (~finished).nonzero()[:, 0]
        HOST_SYNCS += 3  # the two nonzero() and the masked index
        if restart.numel():
            wave[:, restart] = wave0
            failed[restart] = failed0
            steps[restart] = 0
            att_collapses[restart] = 0
            att_backtracks[restart] = 0
            prefs[restart] = _draw_prefs(seeds[lanes[restart]], attempts[lanes[restart]], w, h, static_order, loc_heuristic)
        if keep.numel() < m:
            lanes, wave, failed, steps = lanes[keep], wave[:, keep], failed[keep], steps[keep]
            att_collapses, att_backtracks, prefs = att_collapses[keep], att_backtracks[keep], prefs[keep]

    stats = {
        "attempts": attempts,
        "collapses": collapses,
        "backtracks": backtracks,
        "contradictions": contradictions,
    }
    return grid, ok, stats
