"""The batched WFC solver's CUDA kernel (``csrc/wfc_solve.cu``).

``envs/wfc/solver.wfc_solve`` launches it for CUDA tensors; its plain
version is ``envs/wfc/solver.wfc_solve_reference``, which takes the same
per-wave seeds and draws the same counter-stream words, so the two give
the same grids, outcomes and counters.  ``KERNEL_LAUNCHES`` counts the
launches.
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

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def compat_words(adj) -> np.ndarray:
    """bool[4, P, P] adjacency as the kernel's masks uint64 [4, P, NW]: bit
    q % 64 of word q // 64 of row (d, p) set where q may sit in direction d
    of p."""
    adj = np.asarray(adj, bool)
    d, p, q = adj.shape
    nw = (q + 63) // 64
    padded = np.zeros((d, p, nw * 64), bool)
    padded[..., :q] = adj
    bits = padded.reshape(d, p, nw, 64).astype(np.uint64) << np.arange(64, dtype=np.uint64)
    return np.bitwise_or.reduce(bits, axis=-1)


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
    """Solve one wave per row of ``seeds`` (int32 [N, 2], on the card):
    returns (grids int32 [N, W, H], ok bool [N], stats dict of int32 [N])."""
    global KERNEL_LAUNCHES
    device = seeds.device
    _require(device.type == "cuda", f"seeds on {device}, need CUDA (or CPU for the plain version)")
    _require(seeds.dtype == torch.int32 and seeds.dim() == 2 and seeds.shape[1] == 2, "seeds must be int32 [N, 2]")
    adj = adj.cpu().numpy() if isinstance(adj, torch.Tensor) else np.asarray(adj)
    p = adj.shape[1]
    _require(1 <= p <= MAX_PATTERNS, f"{p} patterns, the kernel takes 1 to {MAX_PATTERNS}")
    _require(loc_heuristic in LOC_CODES and choice_heuristic in CHOICE_CODES, "unknown heuristic")
    _require((order is not None) == (loc_heuristic in ("spiral", "hilbert")), "the static order goes with spiral/hilbert")
    lib = load_library("wfc_solve")
    w, h = shape
    lib.wfc_solve_smem_bytes.restype = ctypes.c_longlong
    lib.wfc_solve_smem_bytes.argtypes = [ctypes.c_int] * 4
    smem = lib.wfc_solve_smem_bytes(p, w, h, int(backtracking))
    limit = torch.cuda.get_device_properties(device).shared_memory_per_block_optin
    _require(smem <= limit, f"a {w}x{h} wave of {p} patterns needs {smem} bytes of shared memory, the card has {limit}")
    n = seeds.shape[0]
    compat = torch.from_numpy(compat_words(adj).view(np.int64)).to(device)
    weights = weights.to(device=device, dtype=torch.float32).contiguous()
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
            seeds.data_ptr(), compat.data_ptr(), weights.data_ptr(), 0 if order is None else order.data_ptr(),
            grid.data_ptr(), ok.data_ptr(), stats.data_ptr(), n, p, w, h, int(periodic), int(max_attempts),
            LOC_CODES[loc_heuristic], CHOICE_CODES[choice_heuristic], int(backtracking), stream,
        )
    if err != 0:
        raise RuntimeError(f"wfc_solve kernel launch failed with CUDA error {err}")
    KERNEL_LAUNCHES += 1
    names = ("attempts", "collapses", "backtracks", "contradictions")
    return grid, ok.bool(), {k: stats[i] for i, k in enumerate(names)}
