// The family-extension interface of the whole-rollout kernels
// (fused_rollout.cu, actor_rollout.cu) and the helpers of the counter-reset
// stream.
//
// Device side of minigrid_tpu_torch/ops/fused_ext.py (the JAX package's
// minigrid_tpu/ops/fused_ext.py).  An ext is a struct with
//   PRE_STEP, COUNTER_RESET  compile-time switches of the kernel's loop;
//   SWITCHES                 the kernel switches NO_OBJECTS, STATIC_MISSION,
//                            SEE_THROUGH (in that order) it is instantiated
//                            at: 1 or 0, or SWITCH_ANY for both;
//   MAX_K                    the most extra int32 scalars it carries;
//   NUM_PLANES               its extra planes: P per env of W*H bytes,
//                            handed to the hooks as the env's column of the
//                            actor kernel's env-minor [P, W*H, N] (stride
//                            N) or its row of the random-policy kernel's
//                            env-major [N, P, W*H] (stride 1), which a
//                            reset copies from the reset-cache slot with the
//                            level;
//   FRONT_BEFORE             whether post_step reads the front cell's
//                            value from before the core step (the kernels
//                            load it only then);
//   POSS_ON_DROP             whether a drop action sets plane 1 to plane 0
//                            (BabyAI's poss = gridm), which the
//                            random-policy kernel leaves to the whole warp
//                            (the ext's verify<true>);
//   Extra                    its extra scalars (registers in the
//                            random-policy kernel, shared memory in the
//                            actor kernel);
//   load / store             Extra from / to the env's K scalars at
//                            stride N (the actor kernel's env-minor [K, N])
//                            or 1 (the random-policy kernel's [N, K]): the
//                            live state, or a reset-cache slot's, which
//                            every reset of a cached ext (MAX_K > 0, no
//                            COUNTER_RESET) loads;
//   map_action               the action the core step sees;
//   pre_step                 dynamics before the agent acts, on the
//                            pre-step scalars (step count not yet counted)
//                            and the env's planes;
//   post_step                sees the transition (StepCtx: the grid after
//                            the step, the scalars before and after it, the
//                            unmapped action, the front cell and its value
//                            before the step, the env's planes), may
//                            reshape the reward, the extra scalars and the
//                            planes, returns extra termination;
//   reset                    a fresh level from an episode seed (used with
//                            COUNTER_RESET in place of the reset cache),
//                            written through a ResetCtx (the env's grid,
//                            contents, mission and plane cells at its
//                            stride) by one lane: the actor kernel's lane,
//                            or the random-policy kernel's owner lane while
//                            the rest of its warp waits;
//   WARP_RESET, warp_reset   whether the struct has a warp_reset, the same
//                            level made by the whole warp on stride-1 rows,
//                            which the random-policy kernel then runs in
//                            place of reset;
//   params_ok                (a counter-reset EXT_USER) whether the runtime
//                            parameters, grid and K fit the struct's slots;
//                            without it, K == MAX_K.
// NoExt is the default-hook family; a family derives from it and hides
// what it changes, so each family is one header under ext/ (exts.cuh maps
// kernel ids to them), or one header of its own outside the package, which
// includes "fused_ext.cuh" and is built in as EXT_USER.  Runtime family
// parameters come in ExtParams, by value: the built-in families' named
// fields, and a user family's USER_SLOTS values (FusedExt.user_params).

#pragma once

#include <stdint.h>

#include "minigrid_env.cuh"
#include "prng.cuh"

namespace minigrid {

constexpr int COLOR_GREEN = 1;
constexpr int COLOR_BLUE = 2;
constexpr int EMPTY_CELL = OBJ_EMPTY;
constexpr int GOAL_CELL = OBJ_GOAL | (COLOR_GREEN << 8);
constexpr int BALL_CELL = OBJ_BALL | (COLOR_BLUE << 8);

// Domain-separation tags of the counter-reset stream (ops/fused_ext.py).
constexpr uint32_t RESET_TAG = 0x72657365u;  // "rese"
constexpr uint32_t PLACE_TAG = 0x706C6163u;  // "plac"

// The kernel's ext ids (FusedExt.kernel_id).
enum {
  EXT_NONE = 0,
  EXT_EMPTY_RANDOM = 1,
  EXT_CROSSING = 2,
  EXT_DYNAMIC_OBSTACLES = 3,
  EXT_GOTO_TARGET = 4,
  EXT_FETCH = 5,
  EXT_BABYAI = 6,
  EXT_UNLOCK = 7,
  EXT_PICKUP_TARGET = 8,
  EXT_OBSTRUCTED_MAZE = 9,
  EXT_MEMORY = 10,
  EXT_PUT_NEAR = 11,
  EXT_RED_BLUE_DOORS = 12,
  // A family's own cached ext, from a header outside the package (exts.cuh).
  EXT_USER = 100,
};

// A kernel switch (SWITCHES) that an ext leaves to the runtime flag.
constexpr int SWITCH_ANY = -1;

// The by-value slots of a family written outside the package
// (ops/fused_ext.USER_SLOTS).
constexpr int USER_SLOTS = 4;

struct ExtParams {
  int max_steps;
  int n_obstacles;
  int num_crossings;
  int obstacle_cell;
  int start_x, start_y;  // start_x < 0: a random start
  int start_dir;
  int user[USER_SLOTS];  // a user family's own values, 0 past what it gives
};

// The compiled slots the runtime sizes must fit: Dynamic-Obstacles' balls,
// and Crossing's rivers and candidate rows plus columns.
constexpr int MAX_OBSTACLES = 8;
constexpr int MAX_CROSSINGS = 8;
constexpr int MAX_CROSSING_CANDIDATES = 32;

// The sub-seed of an env's episode with ordinal `ep` (its resets so far).
__device__ __forceinline__ Words episode_seed(uint32_t s0, uint32_t s1, int ep) {
  return threefry2x32(s0, s1, (uint32_t)ep, RESET_TAG);
}

// Placement word k of an episode: word k % 2 of place_draw(e, k / 2).
__device__ __forceinline__ uint32_t place_word(const Words& e, int k) {
  const Words pair = threefry2x32(e.w0, e.w1, PLACE_TAG, (uint32_t)(k >> 1));
  return (k & 1) ? pair.w1 : pair.w0;
}

// The walls-and-goal scaffold (walled_plane with the goal at (W-2, H-2))
// written into the env's grid column.
__device__ __forceinline__ void walled_plane(int* grid, size_t N, int W, int H) {
  for (int x = 0; x < W; ++x) {
    for (int y = 0; y < H; ++y) {
      const bool border = x == 0 || y == 0 || x == W - 1 || y == H - 1;
      grid[(size_t)(x * H + y) * N] = border ? WALL_CELL : EMPTY_CELL;
    }
  }
  grid[(size_t)((W - 2) * H + H - 2) * N] = GOAL_CELL;
}

// Cells of the grid column that are empty and not cell `skip` (-1: none).
__device__ __forceinline__ int count_free(const int* grid, size_t N, int WH, int skip) {
  int count = 0;
  for (int k = 0; k < WH; ++k) count += (grid[(size_t)k * N] & 0xFF) == OBJ_EMPTY && k != skip;
  return count;
}

// nth_true_index over those cells: the linear index of the target-th
// (0-based), or 0 where there are no more than target of them.
__device__ __forceinline__ int nth_free(const int* grid, size_t N, int WH, int skip, int target) {
  for (int k = 0; k < WH; ++k) {
    if ((grid[(size_t)k * N] & 0xFF) == OBJ_EMPTY && k != skip) {
      if (target == 0) return k;
      --target;
    }
  }
  return 0;
}

// A uniform free cell (place_obj's acceptance rule), from one word.
__device__ __forceinline__ int draw_free_cell(const int* grid, size_t N, int WH, int skip, uint32_t bits) {
  return nth_free(grid, N, WH, skip, uniform_index(bits, max(count_free(grid, N, WH, skip), 1)));
}

// Warp-wide forms of the three above, for the random-policy kernel's
// whole-warp counter reset: every lane of a full warp calls them with the
// same env's grid row (an env-major [W*H] row, stride 1) and the same
// arguments, and gets the same result.  Lane l writes or tests cells l,
// l + 32, ...; the scans ballot 32 cells at a time, and the i-th free cell
// is found from each lane's count of the free cells below it, so the
// result is nth_free's, in the same order.  The caller puts __syncwarp()
// between a write and a scan that reads it.
constexpr unsigned FULL_WARP = 0xFFFFFFFFu;

__device__ __forceinline__ void warp_walled_plane(int* grid, int W, int H, int lane) {
  const int goal = (W - 2) * H + H - 2;
  for (int k = lane; k < W * H; k += 32) {
    const int x = k / H, y = k - (k / H) * H;
    const bool border = x == 0 || y == 0 || x == W - 1 || y == H - 1;
    grid[k] = k == goal ? GOAL_CELL : border ? WALL_CELL : EMPTY_CELL;
  }
}

__device__ __forceinline__ bool free_cell(const int* grid, int WH, int skip, int k) {
  return k < WH && (grid[k] & 0xFF) == OBJ_EMPTY && k != skip;
}

__device__ __forceinline__ int warp_draw_free_cell(const int* grid, int WH, int skip, uint32_t bits, int lane) {
  int count = 0;
  for (int k0 = 0; k0 < WH; k0 += 32) count += __popc(__ballot_sync(FULL_WARP, free_cell(grid, WH, skip, k0 + lane)));
  int target = uniform_index(bits, max(count, 1));
  const unsigned below = (1u << lane) - 1u;
  for (int k0 = 0; k0 < WH; k0 += 32) {
    const bool f = free_cell(grid, WH, skip, k0 + lane);
    const unsigned b = __ballot_sync(FULL_WARP, f);
    const int c = __popc(b);
    if (target < c) return k0 + __ffs(__ballot_sync(FULL_WARP, f && __popc(b & below) == target)) - 1;
    target -= c;
  }
  return 0;
}

// The scalar rows of a fresh episode.
__device__ __forceinline__ Scalars fresh_scalars(int ax, int ay, int d, int max_steps) {
  return Scalars{ax, ay, d, 0, 0, max_steps, 0, 0};
}

// One transition as a post-step hook sees it (FusedCtx,
// minigrid_tpu/ops/fused_ext.py:33-94): the env's grid and contents
// columns after the core step, the scalars before it (after the pre-step
// hook) and after it, the unmapped action, the linear index of the front
// cell of the pre-step pose, the one cell the step could write, with its
// value before the step (read only for a FRONT_BEFORE ext, else 0), and
// the env's column of its extra planes (nullptr without).  The kernels
// build it by reference to values they hold anyway, so a hook that ignores
// a member costs nothing.
struct StepCtx {
  const int* grid;
  const int* cont;
  size_t N;
  int W, H;
  const Scalars& prev;
  const Scalars& post;
  int action;
  int front;
  int front_before;
  uint8_t* planes;
};

// Where a counter reset writes an env's fresh level (reset, warp_reset):
// its grid, contents and mission, element k at [k * N], and its extra
// planes, plane q's cell k at planes[(q * W * H + k) * N].  N is the cell
// stride: N envs in the actor kernel's env-minor columns, 1 in the
// random-policy kernel's env-major rows.  cont, mis and planes are nullptr
// where the kernel's instantiation carries none (NO_OBJECTS, STATIC_MISSION,
// no planes): a reset writes what is set, every cell of it (M mission slots,
// the unused ones 0), as the plain version's reset_block makes a whole
// level.
struct ResetCtx {
  int* grid;
  int* cont;
  int* mis;
  uint8_t* planes;
  size_t N;
  int W, H, M;
};

struct NoExt {
  static constexpr bool PRE_STEP = false;
  static constexpr bool COUNTER_RESET = false;
  static constexpr bool WARP_RESET = false;
  static constexpr int SWITCHES[3] = {SWITCH_ANY, SWITCH_ANY, SWITCH_ANY};
  static constexpr int MAX_K = 0;
  static constexpr int NUM_PLANES = 0;
  static constexpr bool FRONT_BEFORE = false;
  static constexpr bool POSS_ON_DROP = false;
  struct Extra {};

  __device__ static Extra load(const int*, int, size_t, const ExtParams&) { return Extra{}; }
  __device__ static void store(int*, int, size_t, const ExtParams&, const Extra&) {}
  __device__ static int map_action(int action) { return action; }
  __device__ static void pre_step(const ExtParams&, int*, uint8_t*, size_t, int, int, const Scalars&, Extra&) {}
  __device__ static bool post_step(const ExtParams&, const StepCtx&, float&, Extra&) { return false; }
  __device__ static void reset(const ExtParams&, const Words&, const ResetCtx&, Scalars&, Extra&) {}
  // Never called: a struct that keeps it is held to K == MAX_K (ext_params_ok).
  static bool params_ok(const ExtParams&, int, int, int) { return true; }
};

// Whether counter-reset ext `ext_id`'s runtime parameters, grid and K
// extra scalars fit the compiled slots; both kernels refuse a launch where
// they do not.  A user struct answers with its params_ok, or, where it
// declares none, K == MAX_K.
template <class Ext>
bool ext_params_ok(int ext_id, const ExtParams& p, int W, int H, int K) {
  switch (ext_id) {
    case EXT_EMPTY_RANDOM:
      return K == 0 && W >= 3 && H >= 3;
    case EXT_CROSSING: {
      const int n_cand = (H > 3 ? (H - 3) / 2 : 0) + (W > 3 ? (W - 3) / 2 : 0);
      return K == 0 && p.num_crossings >= 0 && p.num_crossings <= MAX_CROSSINGS &&
             p.num_crossings <= n_cand && n_cand <= MAX_CROSSING_CANDIDATES;
    }
    case EXT_DYNAMIC_OBSTACLES:
      return p.n_obstacles >= 0 && p.n_obstacles <= MAX_OBSTACLES && K == 2 * p.n_obstacles + 3 &&
             p.start_x < W && p.start_y < H;
    case EXT_USER:
      if constexpr (&Ext::params_ok == &NoExt::params_ok) {
        return K == Ext::MAX_K;
      } else {
        return Ext::params_ok(p, W, H, K);
      }
    default:
      return false;
  }
}

// The switches that a library built for one family's shape fixes to that
// family's flags (ops/_build.Shape: -DMINIGRID_NO_OBJECTS=0|1,
// -DMINIGRID_STATIC_MISSION, -DMINIGRID_SEE_THROUGH); none in the built-in
// libraries.
#ifdef MINIGRID_NO_OBJECTS
constexpr int LIBRARY_SWITCHES[3] = {MINIGRID_NO_OBJECTS, MINIGRID_STATIC_MISSION, MINIGRID_SEE_THROUGH};
#else
constexpr int LIBRARY_SWITCHES[3] = {SWITCH_ANY, SWITCH_ANY, SWITCH_ANY};
#endif

// Switch i of ext Ext: its SWITCHES entry, else the library's, SWITCH_ANY
// past them (the random-policy kernel's COMPUTE_OBS).
template <class Ext>
constexpr int ext_switch(int i) {
  return i >= 3 ? SWITCH_ANY : Ext::SWITCHES[i] != SWITCH_ANY ? Ext::SWITCHES[i] : LIBRARY_SWITCHES[i];
}

// Whether a whole-rollout kernel takes ext Ext (id `ext_id`) with these
// sizes, runtime flags (NO_OBJECTS, STATIC_MISSION, SEE_THROUGH first) and
// buffers.  The flags must meet the ext's SWITCHES (and the library's), and
// P its NUM_PLANES.
// NoExt reads an R >= 1 reset cache and no extra scalars.  A cached ext
// (extra scalars, no COUNTER_RESET) reads an R >= 1 reset cache with its
// K = MAX_K scalars ([R, K, N] `cscal`) and its P planes ([R, P, W*H, N]
// `cplanes`) beside its live ones, and no seeds.  A counter-reset ext reads
// per-env seeds, its K scalars and its P planes, which its reset writes, and
// no cache.
template <class Ext>
bool ext_launch_ok(int ext_id, const ExtParams& p, int W, int H, int R, int K, int P, const int* flags,
                   const int* scal, const int* cscal, const int* seeds, const uint8_t* planes,
                   const uint8_t* cplanes) {
  for (int i = 0; i < 3; ++i) {
    const int sw = ext_switch<Ext>(i);
    if (sw != SWITCH_ANY && sw != (flags[i] != 0)) return false;
  }
  if (P != Ext::NUM_PLANES || (P > 0 && planes == nullptr)) return false;
  if (Ext::COUNTER_RESET) {
    return R == 0 && seeds != nullptr && cplanes == nullptr && (K == 0 || scal != nullptr) &&
           ext_params_ok<Ext>(ext_id, p, W, H, K);
  }
  if (P > 0 && cplanes == nullptr) return false;
  if (Ext::MAX_K == 0) return R >= 1 && K == 0;
  return R >= 1 && seeds == nullptr && scal != nullptr && cscal != nullptr && K == Ext::MAX_K;
}

}  // namespace minigrid
