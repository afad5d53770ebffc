// Every family ext of the whole-rollout kernels (fused_rollout.cu,
// actor_rollout.cu), by kernel id (fused_ext.cuh's EXT_*, the Python side's
// FusedExt.kernel_id).

#pragma once

#include "ext/babyai.cuh"
#include "ext/crossing.cuh"
#include "ext/dynamic_obstacles.cuh"
#include "ext/empty_random.cuh"
#include "ext/fetch.cuh"
#include "ext/goto_target.cuh"
#include "ext/memory.cuh"
#include "ext/obstructed_maze.cuh"
#include "ext/pickup_target.cuh"
#include "ext/put_near.cuh"
#include "ext/red_blue_doors.cuh"
#include "ext/unlock.cuh"
#include "fused_ext.cuh"

namespace minigrid {

// Calls f(Ext{}) with the ext struct of `ext_id`; does nothing for an
// unknown id.
template <class F>
void with_ext(int ext_id, F&& f) {
  switch (ext_id) {
    case EXT_NONE:
      f(NoExt{});
      break;
    case EXT_EMPTY_RANDOM:
      f(EmptyRandomExt{});
      break;
    case EXT_CROSSING:
      f(CrossingExt{});
      break;
    case EXT_DYNAMIC_OBSTACLES:
      f(DynamicObstaclesExt{});
      break;
    case EXT_GOTO_TARGET:
      f(GoToTargetExt{});
      break;
    case EXT_FETCH:
      f(FetchExt{});
      break;
    case EXT_BABYAI:
      f(BabyAIExt{});
      break;
    case EXT_UNLOCK:
      f(UnlockExt{});
      break;
    case EXT_PICKUP_TARGET:
      f(PickupTargetExt{});
      break;
    case EXT_OBSTRUCTED_MAZE:
      f(ObstructedMazeExt{});
      break;
    case EXT_MEMORY:
      f(MemoryExt{});
      break;
    case EXT_PUT_NEAR:
      f(PutNearExt{});
      break;
    case EXT_RED_BLUE_DOORS:
      f(RedBlueDoorsExt{});
      break;
  }
}

}  // namespace minigrid
