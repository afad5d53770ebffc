"""WFC environment (reference: minigrid/envs/wfc/wfcenv.py:30-258).

Counterpart of ``minigrid_tpu/envs/wfc/wfcenv.py``: a batch of levels is one
batched solve (``solver.wfc_solve``), the pattern grid's anchor tiles become
walls and floor, the largest 4-connected floor component is kept, and start
and goal are two distinct cells of it.
"""

from __future__ import annotations

import time

import torch
import torch.nn.functional as F

from minigrid_tpu_torch.core import grid as g
from minigrid_tpu_torch.core.constants import GOAL_CELL, WALL_CELL
from minigrid_tpu_torch.core.env import MiniGridEnv
from minigrid_tpu_torch.core.mission import mission_vec, template_id
from minigrid_tpu_torch.core.sampling import rand_dir, sample_mask_cell
from minigrid_tpu_torch.core.state import EnvState, new_state, resolve_device
from minigrid_tpu_torch.envs.wfc import solver
from minigrid_tpu_torch.envs.wfc.preprocess import WFC_PRESETS, WFCConfig, build_tables, preset_tables
from minigrid_tpu_torch.utils.chunked import chunked, lane_cap

_MISSION_TEXT = "traverse the maze to get to the goal"
_MISSION = mission_vec(template_id(_MISSION_TEXT))
# Label-propagation sweeps between the host's fixed-point checks.
_LABEL_CHECK = 16


def _largest_component(nav: torch.Tensor) -> torch.Tensor:
    """Keep only each env's largest 4-connected navigable component (of size
    > 1; the first on ties) of bool[N, w, h] ``nav``: the reference's
    graph-based filtering (wfcenv.py:216-245) as label propagation and a
    count.  The JAX package runs (w*h)//2 + 2 sweeps; here the sweeps stop
    at the fixed point, at most that many, which gives the same labels."""
    n, w, h = nav.shape
    big = w * h + 7
    cells = torch.arange(w * h, dtype=torch.int32, device=nav.device).reshape(w, h)
    lab = torch.where(nav, cells, big)
    sweeps, done = (w * h) // 2 + 2, 0
    while done < sweeps:
        before = lab
        for _ in range(min(_LABEL_CHECK, sweeps - done)):
            p = F.pad(lab, (1, 1, 1, 1), value=big)
            m = torch.minimum(
                torch.minimum(p[:, 2:, 1:-1], p[:, :-2, 1:-1]),
                torch.minimum(p[:, 1:-1, 2:], p[:, 1:-1, :-2]),
            )
            lab = torch.where(nav, torch.minimum(lab, m), lab)
        done += min(_LABEL_CHECK, sweeps - done)
        if torch.equal(lab, before):
            break
    counts = torch.zeros((n, w * h + 8), dtype=torch.int32, device=nav.device)
    counts.scatter_add_(1, lab.reshape(n, -1).long(), nav.reshape(n, -1).to(torch.int32))
    counts[:, big] = 0
    counts = torch.where(counts > 1, counts, 0)  # drop singleton components
    best = counts.argmax(dim=1)
    return nav & (lab == best[:, None, None])


class WFCEnv(MiniGridEnv):
    """Level generation via Wave Function Collapse from B/W pattern images
    (reference: minigrid/envs/wfc/wfcenv.py:114-258)."""

    expensive_reset = True

    def __init__(
        self,
        wfc_config: str | WFCConfig = "MazeSimple",
        size: int = 25,
        ensure_connected: bool = True,
        max_steps: int | None = None,
        max_attempts: int = 64,
        **kwargs,
    ):
        if size < 3:
            raise ValueError(f"Grid size must be at least 3 (currently {size})")
        if max_steps is None:
            max_steps = size * 20
        super().__init__(width=size, height=size, max_steps=max_steps, **kwargs)
        self.config = wfc_config if isinstance(wfc_config, WFCConfig) else WFC_PRESETS[wfc_config]
        self._tables = build_tables(self.config) if isinstance(wfc_config, WFCConfig) else preset_tables(wfc_config)
        self.ensure_connected = ensure_connected
        self.max_attempts = max_attempts

    def solver_lanes(self, device) -> int:
        """Levels per solve on ``device``.  The kernel keeps a wave in shared
        memory, so on the card the chunk is the grid's own, as for every
        family (``utils/chunked.lane_cap``).  A lane of the plain version
        holds a P x (size-2)^2 wave and the float operands of its products,
        so elsewhere the chunk is capped by P * (size-2)^2 cells."""
        if torch.device(device).type == "cuda":
            return lane_cap(self.width * self.height)
        inner = self.width - 2
        return lane_cap(self._tables["patterns"].shape[0] * inner * inner)

    def _generate(self, num_envs: int, generator: torch.Generator | None, device) -> EnvState:
        lanes = self.solver_lanes(device)
        return chunked(lambda count: self._generate_chunk(count, generator, device), num_envs, lanes)

    def _generate_chunk(self, n: int, generator: torch.Generator | None, device) -> EnvState:
        w = h = self.width
        inner = w - 2
        t = self._tables
        pattern_grid, _ = solver.wfc_solve(
            generator,
            t["adj"],
            t["weights"],
            n,
            (inner, inner),
            periodic=self.config.output_periodic,
            max_attempts=self.max_attempts,
            loc_heuristic=self.config.loc_heuristic,
            choice_heuristic=self.config.choice_heuristic,
            backtracking=self.config.backtracking,
            device=device,
        )
        # Pattern anchor tile -> wall/empty (reference wfcenv.py:203-214); a
        # failed solve keeps its last grid, as in the JAX package.
        is_wall_pattern = torch.as_tensor(t["top_left"] == t["wall_tile"], device=device)
        nav = ~is_wall_pattern[pattern_grid.long()]
        if self.ensure_connected:
            nav = _largest_component(nav)

        # Start and goal: two distinct navigable cells (reference :247-258).
        start = sample_mask_cell(generator, nav)
        xs, ys = g.coord_grids(inner, inner, device)
        nav2 = nav & ~((xs == start[:, 0, None, None]) & (ys == start[:, 1, None, None]))
        goal = sample_mask_cell(generator, nav2)

        grid = g.wall_rect(g.empty_grid(n, w, h, device), 0, 0, w, h)
        interior_wall = torch.zeros((n, w, h), dtype=torch.bool, device=device)
        interior_wall[:, 1:-1, 1:-1] = ~nav
        grid = g.put(grid, interior_wall, WALL_CELL)
        grid = g.set_cell(grid, goal[:, 0] + 1, goal[:, 1] + 1, GOAL_CELL)
        return new_state(grid, start + 1, rand_dir(generator, n, device), self.max_steps, mission=_MISSION)

    def mission_text(self, mission=None) -> str:
        return _MISSION_TEXT


def make_log_stats():
    """TSV stats logger mirroring the reference's make_log_stats
    (control.py:44-60): first call writes a header line, every call appends
    one tab-separated row."""
    log_line = 0

    def log_stats(stats: dict, filename: str) -> None:
        nonlocal log_line
        if stats:
            log_line += 1
            with open(filename, "a", encoding="utf_8") as logf:
                if log_line < 2:
                    print("\t".join(str(k) for k in stats), file=logf)
                print("\t".join(str(v) for v in stats.values()), file=logf)

    return log_stats


def execute_wfc(
    generator: torch.Generator | None,
    config: WFCConfig,
    output_size: tuple[int, int] = (25, 25),
    max_attempts: int = 10,
    log_filename: str | None = None,
    log_stats_to_output=None,
    on_choice=None,
    on_observe=None,
    on_propagate=None,
    on_backtrack=None,
    device=None,
    plain: bool = False,
):
    """Host-side solve orchestration with per-run stats, mirroring the
    reference's execute_wfc (control.py:63-294): returns (pattern grid as a
    numpy int32[W, H] | None, stats).  The stats dict carries the input
    parameters, the attempt / collapse / backtrack / contradiction counters
    and the solve duration; pass ``log_stats_to_output=make_log_stats()``
    (and a filename) for the reference's TSV logging.  The event hooks run
    in the plain version, whose steps they see: on the card pass
    ``plain=True`` with them (``solver.wfc_solve`` refuses them otherwise)."""
    t = build_tables(config)
    stats: dict = {
        "pattern": config.pattern,
        "pattern_width": config.pattern_width,
        "rotations": config.rotations,
        "output_size": output_size,
        "attempt_limit": max_attempts,
        "output_periodic": config.output_periodic,
        "input_periodic": config.input_periodic,
        "location heuristic": config.loc_heuristic,
        "choice heuristic": config.choice_heuristic,
        "backtracking": config.backtracking,
        "pattern count": int(t["patterns"].shape[0]),
    }
    t0 = time.perf_counter()
    grid, ok, run_stats = solver.wfc_solve(
        generator,
        t["adj"],
        t["weights"],
        1,
        tuple(output_size),
        periodic=config.output_periodic,
        max_attempts=max_attempts,
        loc_heuristic=config.loc_heuristic,
        choice_heuristic=config.choice_heuristic,
        backtracking=config.backtracking,
        with_stats=True,
        on_choice=on_choice,
        on_observe=on_observe,
        on_propagate=on_propagate,
        on_backtrack=on_backtrack,
        device=resolve_device(generator, device),
        plain=plain,
    )
    ok = bool(ok[0])
    # The counters in the JAX package's order: its jitted solve returns the
    # dict with its keys sorted, and the TSV columns follow.
    stats.update({k: int(run_stats[k][0]) for k in sorted(run_stats)})
    stats["solve duration"] = time.perf_counter() - t0
    stats["outcome"] = "success" if ok else "contradiction"
    if log_stats_to_output is not None and log_filename is not None:
        log_stats_to_output(stats, log_filename)
    return (grid[0].cpu().numpy() if ok else None), stats
