// GoToObject and GoToDoor: `done` next to the target succeeds, `toggle` or
// `done` ends the episode (minigrid_tpu_torch/envs/gotoobject.py::
// GoToTargetFusedExt; the JAX package's minigrid_tpu/envs/gotoobject.py:
// 95-119).  2 extra scalars: the target's x and y, which
// the reset cache blends in with the rest of the level.  Per step the hook
// is a few integer compares on the post-step pose; nothing is loaded.

#pragma once

#include "../fused_ext.cuh"

namespace minigrid {

struct GoToTargetExt : NoExt {
  // Objects, a per-episode mission, see-through walls: GoToObject, GoToDoor.
  static constexpr int SWITCHES[3] = {0, 0, 1};
  static constexpr int MAX_K = 2;

  struct Extra {
    int tx, ty;
  };

  __device__ static Extra load(const int* scal, int n, size_t N, const ExtParams&) {
    return Extra{scal[n], scal[N + n]};
  }

  __device__ static void store(int* scal, int n, size_t N, const ExtParams&, const Extra& x) {
    scal[n] = x.tx;
    scal[N + n] = x.ty;
  }

  __device__ static bool post_step(const ExtParams&, const StepCtx& ctx, float& reward, Extra& x) {
    const int ax = ctx.post.ax, ay = ctx.post.ay;
    const bool next_to = (ax == x.tx && abs(ay - x.ty) == 1) || (ay == x.ty && abs(ax - x.tx) == 1);
    const bool is_done = ctx.action == ACT_DONE;
    if (is_done && next_to) reward = success_reward(ctx.post);
    return is_done || ctx.action == ACT_TOGGLE;
  }
};

}  // namespace minigrid
