// Every family ext of the whole-rollout kernels (fused_rollout.cu,
// actor_rollout.cu), by kernel id (fused_ext.cuh's EXT_*, the Python side's
// FusedExt.kernel_id).
//
// Built with MINIGRID_USER_EXT defined (ops/_build.load_library with a
// header: -DMINIGRID_USER_EXT=<struct>, and an include directory holding
// minigrid_user_ext.cuh, which includes the family's own header), the
// library holds that one struct instead, as EXT_USER: a family written
// outside the package, a cached ext or a counter-reset one, pays for its
// own instantiations only.  Built with MINIGRID_ONLY_EXT=<id> (a library
// of one view or width, ops/_build.Shape), it holds the ext of that id
// alone: the family that launched the build.

#pragma once

#ifdef MINIGRID_USER_EXT
#include "fused_ext.cuh"
#include "minigrid_user_ext.cuh"
#else
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
#endif

namespace minigrid {

// Whether this library holds the built-in ext of `ext_id`.
constexpr bool holds_ext(int ext_id) {
#ifdef MINIGRID_ONLY_EXT
  return ext_id == MINIGRID_ONLY_EXT;
#else
  return ext_id >= 0;
#endif
}

// Calls f(Ext{}) with the ext struct of `ext_id`; does nothing for an
// unknown id or one the library does not hold.
template <class F>
void with_ext(int ext_id, F&& f) {
  switch (ext_id) {
#ifdef MINIGRID_USER_EXT
    case EXT_USER:
      f(MINIGRID_USER_EXT{});
      break;
#else
    case EXT_NONE:
      if constexpr (holds_ext(EXT_NONE)) f(NoExt{});
      break;
    case EXT_EMPTY_RANDOM:
      if constexpr (holds_ext(EXT_EMPTY_RANDOM)) f(EmptyRandomExt{});
      break;
    case EXT_CROSSING:
      if constexpr (holds_ext(EXT_CROSSING)) f(CrossingExt{});
      break;
    case EXT_DYNAMIC_OBSTACLES:
      if constexpr (holds_ext(EXT_DYNAMIC_OBSTACLES)) f(DynamicObstaclesExt{});
      break;
    case EXT_GOTO_TARGET:
      if constexpr (holds_ext(EXT_GOTO_TARGET)) f(GoToTargetExt{});
      break;
    case EXT_FETCH:
      if constexpr (holds_ext(EXT_FETCH)) f(FetchExt{});
      break;
    case EXT_BABYAI:
      if constexpr (holds_ext(EXT_BABYAI)) f(BabyAIExt{});
      break;
    case EXT_UNLOCK:
      if constexpr (holds_ext(EXT_UNLOCK)) f(UnlockExt{});
      break;
    case EXT_PICKUP_TARGET:
      if constexpr (holds_ext(EXT_PICKUP_TARGET)) f(PickupTargetExt{});
      break;
    case EXT_OBSTRUCTED_MAZE:
      if constexpr (holds_ext(EXT_OBSTRUCTED_MAZE)) f(ObstructedMazeExt{});
      break;
    case EXT_MEMORY:
      if constexpr (holds_ext(EXT_MEMORY)) f(MemoryExt{});
      break;
    case EXT_PUT_NEAR:
      if constexpr (holds_ext(EXT_PUT_NEAR)) f(PutNearExt{});
      break;
    case EXT_RED_BLUE_DOORS:
      if constexpr (holds_ext(EXT_RED_BLUE_DOORS)) f(RedBlueDoorsExt{});
      break;
#endif
  }
}

}  // namespace minigrid

// The ext of `ext_id` as this library compiled it, for the wrappers to hold
// a family's Python twin to: out = {MAX_K, NUM_PLANES, SWITCHES[0..2],
// COUNTER_RESET, PRE_STEP}.  Returns 0 for an id the library does not hold.
extern "C" int minigrid_ext_layout(int ext_id, int* out) {
  int found = 0;
  minigrid::with_ext(ext_id, [&](auto ext) {
    using Ext = decltype(ext);
    const int layout[7] = {Ext::MAX_K,       Ext::NUM_PLANES,    Ext::SWITCHES[0], Ext::SWITCHES[1],
                           Ext::SWITCHES[2], Ext::COUNTER_RESET, Ext::PRE_STEP};
    for (int i = 0; i < 7; ++i) out[i] = layout[i];
    found = 1;
  });
  return found;
}
