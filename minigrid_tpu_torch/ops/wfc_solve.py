"""The batched WFC solver's CUDA kernel (``csrc/wfc_solve.cu``).

``envs/wfc/solver.wfc_solve`` launches it for CUDA tensors; its plain
version is ``envs/wfc/solver.wfc_solve_reference``, which takes the same
per-wave seeds and draws the same counter-stream words, so the two give
the same grids, outcomes and counters.  The kernel runs one warp a wave and
several waves a block; ``wfc_solve_layout`` mirrors its C layout (the
shared memory of a block and of a wave, the waves a block).
``KERNEL_LAUNCHES`` counts the launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from minigrid_tpu_torch.ops._build import load_library

KERNEL_LAUNCHES = 0

LOC_CODES = {"entropy": 0, "anti-entropy": 1, "random": 2, "simple": 3, "lexical": 4, "spiral": 5, "hilbert": 6}
CHOICE_CODES = {"weighted": 0, "random": 1, "lexical": 2, "rarest": 3, "most-common": 4}
MAX_PATTERNS = 256
# The kernel's launch bound on the waves (warps) of a block, by words a
# cell, and the shared memory a block keeps off the layout
# (``csrc/wfc_solve.cu``: ``max_waves``, ``SMEM_RESERVE``).
MAX_WAVES = {1: 24, 2: 16, 3: 16, 4: 16}
SMEM_RESERVE = 256

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
# (device, adj's shape and bytes, the weights' bytes) -> the support table
# and float32 weights on that device, made once: a copy from pageable host
# memory to the card waits for the stream, which would hold every call.
_TABLES: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}
_TABLES_MAX = 64


def support_words(adj) -> np.ndarray:
    """bool[4, P, P] adjacency (``adj[d, p, q]``: q may sit in direction d of
    p) as the kernel's support table uint64 [P, 4, NW]: bit p % 64 of word
    p // 64 of row (q, d) set where ``adj[(d + 2) % 4, p, q]``, the patterns
    p that a cell in direction d of a cell holding q may keep.  Built from
    ``adj`` transposed, with no symmetry assumed."""
    adj = np.asarray(adj, bool)
    _, p, q = adj.shape
    nw = (p + 63) // 64
    rows = np.zeros((q, 4, nw * 64), bool)
    for d in range(4):
        rows[:, d, :p] = adj[(d + 2) % 4].T
    bits = rows.reshape(q, 4, nw, 64).astype(np.uint64) << np.arange(64, dtype=np.uint64)
    return np.bitwise_or.reduce(bits, axis=-1)


def _align16(x: int) -> int:
    return (x + 15) & ~15


def wfc_solve_layout(p: int, w: int, h: int, backtracking: bool, n: int, sms: int, limit: int) -> dict:
    """The kernel's shared-memory layout (``wfc_layout`` and
    ``waves_per_block`` in ``csrc/wfc_solve.cu``) for n waves of p patterns
    on a w x h grid, on a card of ``sms`` SMs and ``limit`` bytes of shared
    memory a block: a block's own bytes (its next-wave counter, the support
    table, the weights as float64, the neighbour table), a wave's bytes
    (masks, the snapshot's masks and scores with backtracking, scores,
    preferences, the work list's ring and queued bits), the waves a block
    (as many as fit, at most ``MAX_WAVES``, no more than ceil(n / sms); 0 if
    one does not fit) and a block's dynamic shared memory."""
    nw = (p + 63) // 64
    cells, bt = w * h, int(bool(backtracking))
    block = _align16(_align16(_align16(16 + 32 * p * nw) + 8 * p) + 8 * cells)
    wave = 0
    for size in (8 * cells * nw, bt * 8 * cells * nw, 4 * cells, bt * 4 * cells, 4 * cells, 2 * cells):
        wave = _align16(wave + size)
    wave = _align16(wave + 4 * ((cells + 31) // 32))
    room = limit - SMEM_RESERVE - block
    per_block = 0 if room < wave else min(room // wave, MAX_WAVES[nw], max(1, -(-n // sms)))
    return {"block_bytes": block, "wave_bytes": wave, "waves_per_block": per_block,
            "smem_bytes": block + per_block * wave}


def _device_tables(adj: np.ndarray, weights, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The support table (``support_words``) and the float32 weights on
    ``device``; weights already on the card are taken as they are."""
    on_card = isinstance(weights, torch.Tensor) and weights.device.type == "cuda"
    host_weights = None if on_card else np.ascontiguousarray(
        weights.cpu().numpy() if isinstance(weights, torch.Tensor) else weights, np.float32
    )
    key = (str(device), adj.shape, adj.tobytes(), None if on_card else host_weights.tobytes())
    if key not in _TABLES:
        if len(_TABLES) >= _TABLES_MAX:
            _TABLES.clear()
        support = torch.from_numpy(support_words(adj).view(np.int64)).to(device)
        _TABLES[key] = support, None if on_card else torch.from_numpy(host_weights).to(device)
    support, cached = _TABLES[key]
    return support, (weights.to(dtype=torch.float32).contiguous() if on_card else cached)


def _require(cond: bool, message: str) -> None:
    if not cond:
        raise ValueError(f"wfc_solve kernel: {message}")


def wfc_solve_kernel(
    seeds: torch.Tensor,
    adj,
    weights: torch.Tensor,
    order: torch.Tensor | None,
    shape: tuple[int, int],
    periodic: bool,
    max_attempts: int,
    loc_heuristic: str,
    choice_heuristic: str,
    backtracking: bool,
):
    """Solve one wave per row of ``seeds`` (int32 [N, 2], on the card) over
    ``adj`` (bool [4, P, P], best on the host: it is read there) and
    ``weights`` (float32 [P], on the host or the card): returns (grids int32
    [N, W, H], ok bool [N], stats dict of int32 [N])."""
    global KERNEL_LAUNCHES
    adj = np.ascontiguousarray(adj.cpu().numpy() if isinstance(adj, torch.Tensor) else adj, bool)
    p = adj.shape[1]
    _require(1 <= p <= MAX_PATTERNS, f"{p} patterns, the kernel takes 1 to {MAX_PATTERNS}")
    _require(loc_heuristic in LOC_CODES and choice_heuristic in CHOICE_CODES, "unknown heuristic")
    _require((order is not None) == (loc_heuristic in ("spiral", "hilbert")), "the static order goes with spiral/hilbert")
    device = seeds.device
    _require(device.type == "cuda", f"seeds on {device}, need CUDA (or CPU for the plain version)")
    _require(seeds.dtype == torch.int32 and seeds.dim() == 2 and seeds.shape[1] == 2, "seeds must be int32 [N, 2]")
    w, h = shape
    n = seeds.shape[0]
    props = torch.cuda.get_device_properties(device)
    limit = props.shared_memory_per_block_optin
    layout = wfc_solve_layout(p, w, h, backtracking, n, props.multi_processor_count, limit)
    need = layout["block_bytes"] + layout["wave_bytes"] + SMEM_RESERVE
    _require(
        layout["waves_per_block"] > 0,
        f"a {w}x{h} wave of {p} patterns needs {need} bytes of shared memory, the card has {limit}",
    )
    lib = load_library("wfc_solve")
    support, weights = _device_tables(adj, weights, device)
    order = None if order is None else order.to(device=device, dtype=torch.float32).contiguous()
    seeds = seeds.contiguous()
    grid = torch.empty((n, w, h), dtype=torch.int32, device=device)
    ok = torch.empty(n, dtype=torch.int32, device=device)
    stats = torch.empty((4, n), dtype=torch.int32, device=device)
    fn = lib.wfc_solve_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            seeds.data_ptr(), support.data_ptr(), weights.data_ptr(), 0 if order is None else order.data_ptr(),
            grid.data_ptr(), ok.data_ptr(), stats.data_ptr(), n, p, w, h, int(periodic), int(max_attempts),
            LOC_CODES[loc_heuristic], CHOICE_CODES[choice_heuristic], int(backtracking), stream,
        )
    if err != 0:
        raise RuntimeError(f"wfc_solve kernel launch failed with CUDA error {err}")
    KERNEL_LAUNCHES += 1
    names = ("attempts", "collapses", "backtracks", "contradictions")
    return grid, ok.bool(), {k: stats[i] for i, k in enumerate(names)}
