// PutNear: a pickup that leaves the agent carrying anything but the object
// to move ends the episode, and so does any drop attempt while carrying; a
// drop that lands Chebyshev-adjacent to the target succeeds
// (minigrid_tpu_torch/envs/putnear.py::PutNearFusedExt; the JAX package's
// minigrid_tpu/envs/putnear.py:119-162).  The landing cell is the one in
// front of the post-step pose, unclipped; whether the agent carried
// something comes from the pre-step scalars.  4 extra scalars: the move
// object's type and color and the target's x and y, which the reset cache
// blends in with the rest of the level.

#pragma once

#include "../fused_ext.cuh"

namespace minigrid {

struct PutNearExt : NoExt {
  // Objects, a per-episode mission, see-through walls.
  static constexpr int SWITCHES[3] = {0, 0, 1};
  static constexpr int MAX_K = 4;

  struct Extra {
    int type, color, tx, ty;
  };

  __device__ static Extra load(const int* scal, int n, size_t N, const ExtParams&) {
    return Extra{scal[n], scal[N + n], scal[2 * N + n], scal[3 * N + n]};
  }

  __device__ static void store(int* scal, int n, size_t N, const ExtParams&, const Extra& x) {
    scal[n] = x.type;
    scal[N + n] = x.color;
    scal[2 * N + n] = x.tx;
    scal[3 * N + n] = x.ty;
  }

  __device__ static bool post_step(const ExtParams&, const StepCtx& ctx, float& reward, Extra& x) {
    const int carry = ctx.post.carry;
    const bool carrying = (carry & 0xFF) != 0;
    const bool wrong = carrying && ((carry & 0xFF) != x.type || ((carry >> 8) & 0xFF) != x.color);
    const bool wrong_pickup = ctx.action == ACT_PICKUP && wrong;
    const bool pre_carrying = (ctx.prev.carry & 0xFF) != 0;
    const bool drop_attempt = ctx.action == ACT_DROP && pre_carrying;
    const int d = ctx.post.d;
    const int fx = ctx.post.ax + (d == 0) - (d == 2);
    const int fy = ctx.post.ay + (d == 1) - (d == 3);
    const bool near_target = abs(fx - x.tx) <= 1 && abs(fy - x.ty) <= 1;
    if (drop_attempt && !carrying && near_target) reward = success_reward(ctx.post);
    return wrong_pickup || drop_attempt;
  }
};

}  // namespace minigrid
