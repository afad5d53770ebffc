// ObstructedMaze: a pickup that leaves the agent carrying the blue ball
// succeeds (minigrid_tpu_torch/envs/obstructedmaze.py::
// ObstructedMazeFusedExt; the JAX package's
// minigrid_tpu/envs/obstructedmaze.py:211-226).  No extra scalars: its
// levels, the keys boxed in the contents plane included, come from the
// reset cache as NoExt's do.  Per step the hook compares the post-step
// carried word.

#pragma once

#include "../fused_ext.cuh"

namespace minigrid {

struct ObstructedMazeExt : NoExt {
  // Objects (keys inside boxes), a per-episode mission, occluding walls.
  static constexpr int SWITCHES[3] = {0, 0, 0};

  __device__ static bool post_step(const ExtParams&, const StepCtx& ctx, float& reward, Extra&) {
    const bool success = ctx.action == ACT_PICKUP && (ctx.post.carry & 0xFFFF) == BALL_CELL;
    if (success) reward = success_reward(ctx.post);
    return success;
  }
};

}  // namespace minigrid
