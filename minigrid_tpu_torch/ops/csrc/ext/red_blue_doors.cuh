// RedBlueDoors: opening the blue door after the red one succeeds; opening
// the blue door first, or the red one after the blue one, fails
// (minigrid_tpu_torch/envs/redbluedoors.py::RedBlueDoorsFusedExt; the JAX
// package's minigrid_tpu/envs/redbluedoors.py:82-111).  The hook needs both
// doors before and after the step.  A step writes only its front cell, so
// a door's pre-step cell is the front cell's value before the step
// (FRONT_BEFORE) where the door is the front cell, and its post-step cell
// otherwise.  4 extra scalars: the red door's x and y, then the blue
// door's, which the reset cache blends in with the rest of the level.

#pragma once

#include "../fused_ext.cuh"

namespace minigrid {

struct RedBlueDoorsExt : NoExt {
  // Objects, a per-episode mission, occluding walls.
  static constexpr int SWITCHES[3] = {0, 0, 0};
  static constexpr int MAX_K = 4;
  static constexpr bool FRONT_BEFORE = true;

  struct Extra {
    int rx, ry, bx, by;
  };

  __device__ static Extra load(const int* scal, int n, size_t N, const ExtParams&) {
    return Extra{scal[n], scal[N + n], scal[2 * N + n], scal[3 * N + n]};
  }

  __device__ static void store(int* scal, int n, size_t N, const ExtParams&, const Extra& x) {
    scal[n] = x.rx;
    scal[N + n] = x.ry;
    scal[2 * N + n] = x.bx;
    scal[3 * N + n] = x.by;
  }

  __device__ static bool post_step(const ExtParams&, const StepCtx& ctx, float& reward, Extra& x) {
    const int red = x.rx * ctx.H + x.ry, blue = x.bx * ctx.H + x.by;
    const int red_after = ctx.grid[(size_t)red * ctx.N], blue_after = ctx.grid[(size_t)blue * ctx.N];
    const int red_prev = red == ctx.front ? ctx.front_before : red_after;
    const int blue_prev = blue == ctx.front ? ctx.front_before : blue_after;
    const auto is_open = [](int cell) { return ((cell >> 16) & 0xFF) == STATE_OPEN; };
    const bool success = is_open(blue_after) && is_open(red_prev);
    const bool failure = (is_open(blue_after) && !is_open(red_prev)) ||
                         (is_open(red_after) && !is_open(blue_after) && is_open(blue_prev));
    if (success) {
      reward = success_reward(ctx.post);
    } else if (failure) {
      reward = 0.0f;
    }
    return success || failure;
  }
};

}  // namespace minigrid
