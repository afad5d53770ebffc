// Random-start Empty: identity step hooks and the counter-reset level
// (minigrid_tpu_torch/envs/empty.py::_EmptyRandomResetExt; the JAX
// package's minigrid_tpu/envs/empty.py::_EmptyRandomResetExt): the
// walls-and-goal scaffold, the agent on the place_draw(e, 0).w0-th empty
// cell, its direction uniform_index(place_draw(e, 0).w1, 4).  `reset` is the
// per-lane form (the actor kernel), `warp_reset` the whole-warp form (the
// random-policy kernel).

#pragma once

#include "../fused_ext.cuh"

namespace minigrid {

struct EmptyRandomExt : NoExt {
  static constexpr bool COUNTER_RESET = true;
  static constexpr bool WARP_RESET = true;
  // Its reset writes neither contents nor mission.
  static constexpr int SWITCHES[3] = {1, 1, SWITCH_ANY};

  __device__ static void reset(const ExtParams& p, const Words& e, const ResetCtx& rc, Scalars& s, Extra&) {
    int* grid = rc.grid;
    const size_t N = rc.N;
    const int W = rc.W, H = rc.H;
    walled_plane(grid, N, W, H);
    const Words b = threefry2x32(e.w0, e.w1, PLACE_TAG, 0u);
    const int lin = draw_free_cell(grid, N, W * H, -1, b.w0);
    s = fresh_scalars(lin / H, lin % H, uniform_index(b.w1, 4), p.max_steps);
  }

  // The same level, made by a whole warp on the env's grid row (stride 1).
  __device__ static void warp_reset(const ExtParams& p, const Words& e, const ResetCtx& rc, Scalars& s,
                                    Extra&, int lane) {
    int* grid = rc.grid;
    const int W = rc.W, H = rc.H;
    warp_walled_plane(grid, W, H, lane);
    __syncwarp();
    const Words b = threefry2x32(e.w0, e.w1, PLACE_TAG, 0u);
    const int lin = warp_draw_free_cell(grid, W * H, -1, b.w0, lane);
    s = fresh_scalars(lin / H, lin % H, uniform_index(b.w1, 4), p.max_steps);
  }
};

}  // namespace minigrid
