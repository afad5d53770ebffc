// Unlock: a toggle after which the level's locked door is open succeeds
// (minigrid_tpu_torch/envs/unlock.py::UnlockFusedExt; the JAX package's
// minigrid_tpu/envs/unlock.py:146-163).  2 extra scalars: the door's x and
// y, which the reset cache blends in with the rest of the level.  Per step
// the hook reads the door's cell of the post-step grid.

#pragma once

#include "../fused_ext.cuh"

namespace minigrid {

struct UnlockExt : NoExt {
  // Objects, a per-episode mission, occluding walls.
  static constexpr int SWITCHES[3] = {0, 0, 0};
  static constexpr int MAX_K = 2;

  struct Extra {
    int dx, dy;
  };

  __device__ static Extra load(const int* scal, int n, size_t N, const ExtParams&) {
    return Extra{scal[n], scal[N + n]};
  }

  __device__ static void store(int* scal, int n, size_t N, const ExtParams&, const Extra& x) {
    scal[n] = x.dx;
    scal[N + n] = x.dy;
  }

  __device__ static bool post_step(const ExtParams&, const StepCtx& ctx, float& reward, Extra& x) {
    const int door = ctx.grid[(size_t)(x.dx * ctx.H + x.dy) * ctx.N];
    const bool success = ctx.action == ACT_TOGGLE && ((door >> 16) & 0xFF) == STATE_OPEN;
    if (success) reward = success_reward(ctx.post);
    return success;
  }
};

}  // namespace minigrid
