// Memory: pickup acts as toggle; reaching the success or the failure cell
// at the hallway's end ends the episode, rewarded only at the success cell
// (minigrid_tpu_torch/envs/memory.py::MemoryFusedExt; the JAX package's
// minigrid_tpu/envs/memory.py:120-148).  4 extra scalars: the two cells'
// x and y, which the reset cache blends in with the rest of the level.  Per
// step the hook compares the post-step pose; nothing is loaded.

#pragma once

#include "../fused_ext.cuh"

namespace minigrid {

struct MemoryExt : NoExt {
  // Objects, a per-episode mission, occluding walls.
  static constexpr int SWITCHES[3] = {0, 0, 0};
  static constexpr int MAX_K = 4;

  struct Extra {
    int sx, sy, fx, fy;
  };

  __device__ static Extra load(const int* scal, int n, size_t N, const ExtParams&) {
    return Extra{scal[n], scal[N + n], scal[2 * N + n], scal[3 * N + n]};
  }

  __device__ static void store(int* scal, int n, size_t N, const ExtParams&, const Extra& x) {
    scal[n] = x.sx;
    scal[N + n] = x.sy;
    scal[2 * N + n] = x.fx;
    scal[3 * N + n] = x.fy;
  }

  __device__ static int map_action(int action) { return action == ACT_PICKUP ? ACT_TOGGLE : action; }

  __device__ static bool post_step(const ExtParams&, const StepCtx& ctx, float& reward, Extra& x) {
    const int ax = ctx.post.ax, ay = ctx.post.ay;
    const bool at_success = ax == x.sx && ay == x.sy;
    const bool at_failure = ax == x.fx && ay == x.fy;
    if (at_success) {
      reward = success_reward(ctx.post);
    } else if (at_failure) {
      reward = 0.0f;
    }
    return at_success || at_failure;
  }
};

}  // namespace minigrid
