// Whole-rollout random-policy kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel minigrid_tpu/ops/fused_rollout.py::_rollout_kernel
// for families without a fused ext: T environment steps per env with the
// state kept on the card, each step being the core transition
// (_step_block), the auto-reset from the R-slot reset cache (slot
// min(used, R-1), taken with the pre-increment `used`) and, when
// COMPUTE_OBS, the packed-observation checksum of the post-reset state
// (_view_bits_block and _obs_checksum_block: view cells, the carried object
// at the agent cell, the bit-parallel occlusion flood).
//
// Design.  One thread runs one env through all T steps.  Every array is
// env-minor ([..., N]): grid and contents [W*H, N], the 8 scalar rows
// [8, N], mission [M, N], cache [R, W*H, N] / [R, 8, N] / [R, M, N],
// actions [T, N].  The state lives in the output buffers, which the wrapper
// initialises from the input state; the kernel updates them in place and
// allocates nothing.  NO_OBJECTS, STATIC_MISSION, SEE_THROUGH and
// COMPUTE_OBS are compile-time switches, as in the TPU kernel; the view
// size V is a template parameter (7 is instantiated).
//
// What bounds it.  The per-step work is a handful of integer operations
// around data-dependent loads: the front cell (and its contents), and with
// COMPUTE_OBS the V*V view cells.  Neighbouring threads read cells of
// neighbouring envs, but each env reads its own cell index, so a warp's
// loads are gathers of one 4-byte word per 32-byte sector out of L2 (the
// Empty-8x8 grids of 65536 envs are 16 MiB and stay resident in the 50 MB
// L2).  The kernel is bound by those gathered loads and by the latency of
// each thread's sequential chain, at one warp per 32 envs.  What a later
// change could do: stage each block's grids in shared memory (an env-minor
// [W*H][blockDim] tile is free of bank conflicts whatever cell each thread
// reads), and spread one env over several threads of a warp for the view.
//
// Bit-exactness with the JAX package: the reward is computed with
// round-to-nearest intrinsics, never contracted into an FMA; the per-env
// checksum is accumulated in uint32 so that it wraps as int32 does in JAX.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OBJ_EMPTY = 1;
constexpr int OBJ_WALL = 2;
constexpr int OBJ_FLOOR = 3;
constexpr int OBJ_DOOR = 4;
constexpr int OBJ_KEY = 5;
constexpr int OBJ_BALL = 6;
constexpr int OBJ_BOX = 7;
constexpr int OBJ_GOAL = 8;
constexpr int OBJ_LAVA = 9;
constexpr int STATE_OPEN = 0;
constexpr int STATE_LOCKED = 2;
constexpr int COLOR_GREY = 5;
constexpr int WALL_CELL = OBJ_WALL | (COLOR_GREY << 8);

constexpr int ACT_LEFT = 0;
constexpr int ACT_RIGHT = 1;
constexpr int ACT_FORWARD = 2;
constexpr int ACT_PICKUP = 3;
constexpr int ACT_DROP = 4;
constexpr int ACT_TOGGLE = 5;

// Scalar-row order, as in the TPU kernel (fused_rollout.py:62).
enum { ROW_AX, ROW_AY, ROW_DIR, ROW_CARRY, ROW_STEP, ROW_MAX, ROW_TERM, ROW_TRUNC, NUM_SC };

constexpr int THREADS = 128;

struct Args {
  const int* actions;  // [T, N]
  int* grid;           // [W*H, N]  in: initial state, out: final state
  int* cont;           // [W*H, N]
  int* sc;             // [NUM_SC, N]
  int* mis;            // [M, N]
  const int* cgrid;    // [R, W*H, N]
  const int* ccont;    // [R, W*H, N]
  const int* csc;      // [R, NUM_SC, N]
  const int* cmis;     // [R, M, N]
  int* used;           // [N] reset-cache slots consumed
  int* obs;            // [N] observation checksum (int32 wraparound)
  float* rew;          // [N] reward sum
  int* done;           // [N] episodes ended
  int W, H, R, M, T, N;
};

__device__ __forceinline__ bool can_overlap(int t, int s) {
  return t == OBJ_EMPTY || t == OBJ_FLOOR || t == OBJ_GOAL || t == OBJ_LAVA ||
         (t == OBJ_DOOR && s == STATE_OPEN);
}

__device__ __forceinline__ bool can_pickup(int t) {
  return t == OBJ_KEY || t == OBJ_BALL || t == OBJ_BOX;
}

__device__ __forceinline__ bool see_behind(int cell) {
  const int t = cell & 0xFF;
  const int s = (cell >> 16) & 0xFF;
  return !(t == OBJ_WALL || (t == OBJ_DOOR && s != STATE_OPEN));
}

// Sum of the visible packed cells of the agent's V x V view
// (_view_bits_block + _obs_checksum_block).  View cell (i, j) lies at
// agent + f * (V-1-j) - r * (V/2 - i), with f the facing vector and
// r = (-f_y, f_x); cells outside the grid read as walls.
template <int V, bool SEE_THROUGH>
__device__ __forceinline__ uint32_t view_checksum(const int* grid, size_t N, int W, int H,
                                                  int ax, int ay, int d, int carry) {
  const int fx = (d == 0) - (d == 2);
  const int fy = (d == 1) - (d == 3);
  const int rx = -fy;
  const int ry = fx;
  int view[V][V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (i == V / 2 && j == V - 1) {
        // The carried object, or empty, at the agent cell.
        view[i][j] = carry != 0 ? (carry & 0xFFFF) : OBJ_EMPTY;
      } else {
        const int wx = ax + fx * (V - 1 - j) - rx * (V / 2 - i);
        const int wy = ay + fy * (V - 1 - j) - ry * (V / 2 - i);
        const bool inside = wx >= 0 && wx < W && wy >= 0 && wy < H;
        view[i][j] = inside ? grid[(size_t)(wx * H + wy) * N] : WALL_CELL;
      }
    }
  }

  uint32_t sum = 0;
  if (SEE_THROUGH) {
#pragma unroll
    for (int i = 0; i < V; ++i)
#pragma unroll
      for (int j = 0; j < V; ++j) sum += (uint32_t)view[i][j];
    return sum;
  }

  // Bit-parallel occlusion flood (minigrid_tpu/core/obs.py:108-154): bit i
  // of row j's mask is view column i; light floods right in closed carry
  // form, left by V-1 single spreads, and lit transparent cells light the
  // three cells above them.
  constexpr int FULL = (1 << V) - 1;
  int up = 1 << (V / 2);
#pragma unroll
  for (int j = V - 1; j >= 0; --j) {
    int t = 0;
#pragma unroll
    for (int i = 0; i < V; ++i) t |= see_behind(view[i][j]) ? (1 << i) : 0;
    const int m_r = up | ((((up & t) + t) & FULL) ^ t);
    const int cond_r = m_r & t & ((1 << (V - 1)) - 1);
    const int new_up = cond_r | ((cond_r << 1) & FULL);
    int m_l = m_r;
#pragma unroll
    for (int k = 0; k < V - 1; ++k) m_l |= (m_l & t) >> 1;
    const int cond_l = m_l & t & ~1;
    up = new_up | cond_l | (cond_l >> 1);
#pragma unroll
    for (int i = 0; i < V; ++i) sum += ((m_l >> i) & 1) ? (uint32_t)view[i][j] : 0u;
  }
  return sum;
}

template <int V, bool NO_OBJECTS, bool STATIC_MISSION, bool SEE_THROUGH, bool COMPUTE_OBS>
__global__ void __launch_bounds__(THREADS) rollout_kernel(const Args a) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= a.N) return;
  const size_t N = (size_t)a.N;
  const int W = a.W, H = a.H, WH = a.W * a.H;

  // This env's column of every env-minor array: element k at [k * N].
  int* grid = a.grid + n;
  int* cont = a.cont + n;
  int* sc = a.sc + n;
  int* mis = a.mis + n;
  const int* act = a.actions + n;

  int ax = sc[ROW_AX * N], ay = sc[ROW_AY * N], d = sc[ROW_DIR * N];
  int carry = sc[ROW_CARRY * N], step = sc[ROW_STEP * N], max_steps = sc[ROW_MAX * N];
  int term = sc[ROW_TERM * N], trunc = sc[ROW_TRUNC * N];

  int used = 0, done_count = 0;
  uint32_t obs_sum = 0;
  float rew_sum = 0.0f;

  for (int t = 0; t < a.T; ++t) {
    const int action = act[(size_t)t * N];

    // -- Core transition (_step_block, fused_rollout.py:98-206) --
    step += 1;
    const int dx = (d == 0) - (d == 2);
    const int dy = (d == 1) - (d == 3);
    const int fx = min(max(ax + dx, 0), W - 1);
    const int fy = min(max(ay + dy, 0), H - 1);
    const size_t fidx = (size_t)(fx * H + fy) * N;
    const int fcell = grid[fidx];
    const int ftype = fcell & 0xFF;
    const int fcolor = (fcell >> 8) & 0xFF;
    const int fstate = (fcell >> 16) & 0xFF;

    if (action == ACT_LEFT) d = (d + 3) & 3;
    if (action == ACT_RIGHT) d = (d + 1) & 3;
    const bool is_fwd = action == ACT_FORWARD;
    if (is_fwd && can_overlap(ftype, fstate)) {
      ax = fx;
      ay = fy;
    }
    const bool hit_goal = is_fwd && ftype == OBJ_GOAL;
    const bool terminated = hit_goal || (is_fwd && ftype == OBJ_LAVA);
    float reward = 0.0f;
    if (hit_goal) {
      reward = __fsub_rn(1.0f, __fmul_rn(0.9f, __fdiv_rn((float)step, (float)max_steps)));
    }

    if (!NO_OBJECTS) {
      const int fcont = cont[fidx];
      const bool hands_free = carry == 0;
      const bool do_pickup = action == ACT_PICKUP && can_pickup(ftype) && hands_free;
      const bool do_drop = action == ACT_DROP && ftype == OBJ_EMPTY && !hands_free;
      const bool has_key = (carry & 0xFF) == OBJ_KEY && ((carry >> 8) & 0xFF) == fcolor;
      const int door_state = fstate == STATE_LOCKED ? (has_key ? STATE_OPEN : STATE_LOCKED)
                                                    : (fstate == STATE_OPEN ? 1 : 0);
      const bool toggle_door = action == ACT_TOGGLE && ftype == OBJ_DOOR;
      const bool toggle_box = action == ACT_TOGGLE && ftype == OBJ_BOX;
      // The four branches are mutually exclusive.
      if (do_pickup) {
        grid[fidx] = OBJ_EMPTY;
        cont[fidx] = 0;
        carry = ftype | (fcolor << 8) | (fcont << 16);
      } else if (do_drop) {
        grid[fidx] = carry & 0xFFFF;
        cont[fidx] = (carry >> 16) & 0xFFFF;
        carry = 0;
      } else if (toggle_door) {
        grid[fidx] = (fcell & 0xFFFF) | (door_state << 16);
      } else if (toggle_box) {
        grid[fidx] = fcont == 0 ? OBJ_EMPTY : fcont;
        cont[fidx] = 0;
      }
    }
    // Overwritten every step, not accumulated.
    term = terminated;
    trunc = step >= max_steps;
    const bool done = term || trunc;
    rew_sum += reward;
    done_count += done;

    // -- Auto-reset from the cache (fused_rollout.py:445-479) --
    if (done) {
      const int slot = min(used, a.R - 1);
      const int* cg = a.cgrid + (size_t)slot * WH * N + n;
      for (int c = 0; c < WH; ++c) grid[(size_t)c * N] = cg[(size_t)c * N];
      if (!NO_OBJECTS) {
        const int* cc = a.ccont + (size_t)slot * WH * N + n;
        for (int c = 0; c < WH; ++c) cont[(size_t)c * N] = cc[(size_t)c * N];
      }
      const int* cs = a.csc + (size_t)slot * NUM_SC * N + n;
      ax = cs[ROW_AX * N];
      ay = cs[ROW_AY * N];
      d = cs[ROW_DIR * N];
      carry = cs[ROW_CARRY * N];
      step = cs[ROW_STEP * N];
      max_steps = cs[ROW_MAX * N];
      term = cs[ROW_TERM * N];
      trunc = cs[ROW_TRUNC * N];
      if (!STATIC_MISSION) {
        const int* cm = a.cmis + (size_t)slot * a.M * N + n;
        for (int m = 0; m < a.M; ++m) mis[(size_t)m * N] = cm[(size_t)m * N];
      }
      used += 1;
    }

    if (COMPUTE_OBS) obs_sum += view_checksum<V, SEE_THROUGH>(grid, N, W, H, ax, ay, d, carry);
  }

  sc[ROW_AX * N] = ax;
  sc[ROW_AY * N] = ay;
  sc[ROW_DIR * N] = d;
  sc[ROW_CARRY * N] = carry;
  sc[ROW_STEP * N] = step;
  sc[ROW_MAX * N] = max_steps;
  sc[ROW_TERM * N] = term;
  sc[ROW_TRUNC * N] = trunc;
  a.used[n] = used;
  a.obs[n] = (int)obs_sum;
  a.rew[n] = rew_sum;
  a.done[n] = done_count;
}

// Picks the instantiation for the runtime switches, one flag at a time.
template <int V, bool... Fixed>
void dispatch(const Args& a, const int* flags, cudaStream_t stream) {
  if constexpr (sizeof...(Fixed) == 4) {
    const int blocks = (a.N + THREADS - 1) / THREADS;
    rollout_kernel<V, Fixed...><<<blocks, THREADS, 0, stream>>>(a);
  } else {
    if (flags[sizeof...(Fixed)]) {
      dispatch<V, Fixed..., true>(a, flags, stream);
    } else {
      dispatch<V, Fixed..., false>(a, flags, stream);
    }
  }
}

}  // namespace

// Launches the rollout on `stream`; returns a cudaError_t (0 on success).
extern "C" int fused_rollout_launch(const int* actions, int* grid, int* cont, int* sc, int* mis,
                                    const int* cgrid, const int* ccont, const int* csc,
                                    const int* cmis, int* used, int* obs, float* rew, int* done,
                                    int W, int H, int V, int R, int M, int T, int N,
                                    int no_objects, int static_mission, int see_through,
                                    int compute_obs, void* stream) {
  if (V != 7 || W < 1 || H < 1 || R < 1 || M < 0 || T < 0 || N < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (N == 0) return (int)cudaSuccess;
  const Args a{actions, grid, cont, sc, mis, cgrid, ccont, csc, cmis, used, obs, rew, done,
               W, H, R, M, T, N};
  const int flags[4] = {no_objects, static_mission, see_through, compute_obs};
  dispatch<7>(a, flags, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
