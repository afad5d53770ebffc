// UnlockPickup, BlockedUnlockPickup and KeyCorridor: a pickup that leaves
// the agent carrying the target (kind, color) succeeds
// (minigrid_tpu_torch/envs/unlock.py::PickupTargetFusedExt; the JAX
// package's minigrid_tpu/envs/unlock.py:166-186 and keycorridor.py:82-100).
// 1 extra scalar: the target's color, which the reset cache blends in with
// the rest of the level; the kind is the family's, by value in
// ExtParams::obstacle_cell (a box, or KeyCorridor's ball or key).  Per step
// the hook compares the post-step carried word; nothing is loaded.

#pragma once

#include "../fused_ext.cuh"

namespace minigrid {

struct PickupTargetExt : NoExt {
  // Objects, a per-episode mission, occluding walls.
  static constexpr int SWITCHES[3] = {0, 0, 0};
  static constexpr int MAX_K = 1;

  struct Extra {
    int color;
  };

  __device__ static Extra load(const int* scal, int n, size_t, const ExtParams&) { return Extra{scal[n]}; }

  __device__ static void store(int* scal, int n, size_t, const ExtParams&, const Extra& x) { scal[n] = x.color; }

  __device__ static bool post_step(const ExtParams& p, const StepCtx& ctx, float& reward, Extra& x) {
    const int carry = ctx.post.carry;
    const bool success =
        ctx.action == ACT_PICKUP && (carry & 0xFF) == p.obstacle_cell && ((carry >> 8) & 0xFF) == x.color;
    if (success) reward = success_reward(ctx.post);
    return success;
  }
};

}  // namespace minigrid
