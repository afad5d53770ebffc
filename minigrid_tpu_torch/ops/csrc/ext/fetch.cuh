// Fetch: any pickup ends the episode, rewarded only where the carried
// (type, color) is the target (minigrid_tpu_torch/envs/fetch.py::
// FetchFusedExt; the JAX package's minigrid_tpu/envs/fetch.py:93-122).
// 2 extra scalars: the target's type and color, which the
// reset cache blends in with the rest of the level.  Per step the hook reads
// the post-step carried word; nothing is loaded.

#pragma once

#include "../fused_ext.cuh"

namespace minigrid {

struct FetchExt : NoExt {
  // Objects, a per-episode mission, see-through walls.
  static constexpr int SWITCHES[3] = {0, 0, 1};
  static constexpr int MAX_K = 2;

  struct Extra {
    int type, color;
  };

  __device__ static Extra load(const int* scal, int n, size_t N, const ExtParams&) {
    return Extra{scal[n], scal[N + n]};
  }

  __device__ static void store(int* scal, int n, size_t N, const ExtParams&, const Extra& x) {
    scal[n] = x.type;
    scal[N + n] = x.color;
  }

  __device__ static bool post_step(const ExtParams&, const StepCtx& ctx, float& reward, Extra& x) {
    const int carry = ctx.post.carry;
    const bool carrying = (carry & 0xFF) != 0;
    if (carrying) {
      const bool match = (carry & 0xFF) == x.type && ((carry >> 8) & 0xFF) == x.color;
      reward = match ? success_reward(ctx.post) : 0.0f;
    }
    return carrying;
  }
};

}  // namespace minigrid
