// Whole-rollout random-policy kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel minigrid_tpu/ops/fused_rollout.py::_rollout_kernel:
// T environment steps per env with the state kept on the card, each step
// being the family's pre-step hook, the core transition (_step_block) on the
// mapped action, the post-step hook (on a StepCtx of the transition), the
// auto-reset and, when COMPUTE_OBS, the packed-observation checksum of the
// post-reset state (_view_bits_block and _obs_checksum_block: view cells,
// the carried object at the agent cell, the bit-parallel occlusion flood).
// The auto-reset either takes reset-cache slot min(used, R-1), with a
// cached ext's extra scalars from the same slot (NoExt, GoToTarget and
// Fetch, and BabyAI with its verifier's two planes), or, for a
// COUNTER_RESET ext, generates a fresh level in place from the env's seed
// and episode ordinal `used` (ext.reset_block); both use the pre-increment
// `used`.
//
// Design.  One thread runs one env through all T steps; the transition,
// the cache reset and the view are the device functions of minigrid_env.cuh,
// which the actor kernel (actor_rollout.cu) shares, and the family hooks
// are an Ext struct (fused_ext.cuh, one header per family under ext/)
// picked at launch by ext_id.  Every array is env-minor ([..., N]): grid and
// contents [W*H, N], the 8 scalar rows [8, N], mission [M, N], the ext's
// extra scalars [K, N] and byte planes [P, W*H, N], seeds [2, N], cache
// [R, W*H, N] / [R, 8, N] / [R, M, N] / [R, K, N] / [R, P, W*H, N],
// actions [T, N].  The state lives in the output buffers, which
// the wrapper initialises from the input state; the kernel updates them in
// place and allocates nothing.  NO_OBJECTS, STATIC_MISSION, SEE_THROUGH and
// COMPUTE_OBS are compile-time switches, as in the TPU kernel; the view
// size V is a template parameter (7 is instantiated).  An ext is
// instantiated only at the switches its SWITCHES fixes (counter-reset exts
// without objects and with a constant mission, since their reset writes
// neither; GoToTarget and Fetch with objects, a per-episode mission and
// see-through walls); ext_launch_ok refuses other flags.
//
// What bounds it.  The per-step work is a handful of integer operations
// around data-dependent loads: the front cell (and its contents), and with
// COMPUTE_OBS the V*V view cells.  Neighbouring threads read cells of
// neighbouring envs, but each env reads its own cell index, so a warp's
// loads are gathers of one 4-byte word per 32-byte sector out of L2 (the
// Empty-8x8 grids of 65536 envs are 16 MiB and stay resident in the 50 MB
// L2).  The kernel is bound by those gathered loads and by the latency of
// each thread's sequential chain, at one warp per 32 envs.  The ext paths
// add, per step, Dynamic-Obstacles' walk (9 gathered loads and 2 stores per
// ball, one threefry per two balls), and per episode end the counter reset:
// W*H coalesced stores of the scaffold (all threads of a warp that reset
// write the same cell index), 2-5 threefry evaluations of 20 rounds, and
// for Dynamic-Obstacles two W*H scans per placed ball.  A cache reset
// copies a whole level from the env's own slot: the slots differ across a
// warp, so those loads are not coalesced, and the warp runs the copy
// whenever any of its lanes resets.  BabyAI's verifier adds, per step, 6
// byte loads of its planes and the status machine's integer work, and per
// drop action a copy of the gridm plane into poss (W*H bytes, coalesced
// across the warp); BabyAI's bench size is 16384 envs, 4 warps per SM, so
// its time is the latency of one env's chain, not the card's throughput.  With FourRooms' 361-cell levels (a
// grid plane beyond the L2) and GoTo's reset every 3.5 steps, that copy,
// not the step, sets the kernel's time.  The resets branch within a warp,
// so a warp runs as long as its slowest env.  What a later
// change could do: stage each block's grids in shared memory (an env-minor
// [W*H][blockDim] tile is free of bank conflicts whatever cell each thread
// reads), spread one env over several threads of a warp for the view, and
// count free cells from the scaffold's closed form instead of scanning, and
// copy a resetting lane's level with the whole warp.
//
// Bit-exactness with the JAX package: the per-env checksum is accumulated in
// uint32 so that it wraps as int32 does in JAX.

#include <cuda_runtime.h>
#include <stdint.h>

#include "exts.cuh"
#include "minigrid_env.cuh"

namespace {

using namespace minigrid;

constexpr int THREADS = 128;

struct Args {
  const int* actions;  // [T, N]
  int* grid;           // [W*H, N]  in: initial state, out: final state
  int* cont;           // [W*H, N]
  int* sc;             // [NUM_SC, N]
  int* mis;            // [M, N]
  const int* cgrid;    // [R, W*H, N]  (NoExt families)
  const int* ccont;    // [R, W*H, N]
  const int* csc;      // [R, NUM_SC, N]
  const int* cmis;     // [R, M, N]
  const int* cscal;    // [R, K, N] (cached exts)
  int* scal;           // [K, N] the ext's extra scalars, in and out
  uint8_t* planes;     // [P, W*H, N] the ext's extra planes, in and out
  const uint8_t* cplanes;  // [R, P, W*H, N] (cached exts with planes)
  const int* seeds;    // [2, N] counter-reset seeds (COUNTER_RESET exts)
  int* used;           // [N] resets so far (cache slots consumed)
  int* obs;            // [N] observation checksum (int32 wraparound)
  float* rew;          // [N] reward sum
  int* done;           // [N] episodes ended
  int W, H, R, M, T, N, K, P;
};

template <int V, class Ext, bool NO_OBJECTS, bool STATIC_MISSION, bool SEE_THROUGH, bool COMPUTE_OBS>
__global__ void __launch_bounds__(THREADS) rollout_kernel(const Args a, const ExtParams p) {
  static_assert(!Ext::COUNTER_RESET || (NO_OBJECTS && STATIC_MISSION),
                "a counter reset writes neither contents nor mission");
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= a.N) return;
  const size_t N = (size_t)a.N;
  const int W = a.W, H = a.H, WH = a.W * a.H;
  const Cache cache{a.cgrid, a.ccont, a.csc, a.cmis, a.cscal, a.cplanes, a.R, a.K, a.P};

  // This env's column of every env-minor array: element k at [k * N].
  int* grid = a.grid + n;
  int* cont = a.cont + n;
  int* sc = a.sc + n;
  int* mis = a.mis + n;
  uint8_t* planes = Ext::NUM_PLANES > 0 ? a.planes + n : nullptr;
  const int* act = a.actions + n;

  Scalars s = load_scalars(sc, N);
  typename Ext::Extra x = Ext::load(a.scal, n, N, p);
  uint32_t seed0 = 0, seed1 = 0;
  if constexpr (Ext::COUNTER_RESET) {
    seed0 = (uint32_t)a.seeds[n];
    seed1 = (uint32_t)a.seeds[N + n];
  }
  int used = 0, done_count = 0;
  uint32_t obs_sum = 0;
  float rew_sum = 0.0f;

  for (int t = 0; t < a.T; ++t) {
    const int action = act[(size_t)t * N];
    if constexpr (Ext::PRE_STEP) Ext::pre_step(p, grid, planes, N, W, H, s, x);
    const Scalars prev = s;
    const Cell f = front_cell(prev, W, H);
    const int front = f.x * H + f.y;
    const int front_before = Ext::FRONT_BEFORE ? grid[(size_t)front * N] : 0;
    float reward = core_step<NO_OBJECTS>(grid, cont, N, W, H, s, Ext::map_action(action));
    const StepCtx ctx{grid, cont, N, W, H, prev, s, action, front, front_before, planes};
    if (Ext::post_step(p, ctx, reward, x)) s.term = 1;
    const bool done = s.term || s.trunc;
    rew_sum += reward;
    done_count += done;
    if (done) {
      if constexpr (Ext::COUNTER_RESET) {
        Ext::reset(p, episode_seed(seed0, seed1, used), grid, N, W, H, s, x);
      } else {
        cache_reset<Ext, NO_OBJECTS, STATIC_MISSION>(cache, p, n, used, grid, cont, mis, planes, N, WH, a.M, s, x);
      }
      used += 1;
    }
    if (COMPUTE_OBS) {
      // Sum of the visible packed cells (_obs_checksum_block).
      int view[V][V];
      view_cells<V>(grid, N, W, H, s, view);
      hide_unseen<V, SEE_THROUGH>(view);
#pragma unroll
      for (int i = 0; i < V; ++i)
#pragma unroll
        for (int j = 0; j < V; ++j) obs_sum += (uint32_t)view[i][j];
    }
  }

  store_scalars(sc, N, s);
  Ext::store(a.scal, n, N, p, x);
  a.used[n] = used;
  a.obs[n] = (int)obs_sum;
  a.rew[n] = rew_sum;
  a.done[n] = done_count;
}

// Picks the instantiation for the runtime switches, one flag at a time;
// `flags` are NO_OBJECTS, STATIC_MISSION, SEE_THROUGH, COMPUTE_OBS.  A
// switch the ext fixes (ext_switch) takes its value, not the flag's.
template <int V, class Ext, bool... Fixed>
void dispatch(const Args& a, const ExtParams& p, const int* flags, cudaStream_t stream) {
  constexpr int i = sizeof...(Fixed);
  if constexpr (i == 4) {
    const int blocks = (a.N + THREADS - 1) / THREADS;
    rollout_kernel<V, Ext, Fixed...><<<blocks, THREADS, 0, stream>>>(a, p);
  } else if constexpr (ext_switch<Ext>(i) != SWITCH_ANY) {
    dispatch<V, Ext, Fixed..., ext_switch<Ext>(i) == 1>(a, p, flags, stream);
  } else {
    if (flags[i]) {
      dispatch<V, Ext, Fixed..., true>(a, p, flags, stream);
    } else {
      dispatch<V, Ext, Fixed..., false>(a, p, flags, stream);
    }
  }
}

}  // namespace

// Launches the rollout on `stream`; returns a cudaError_t (0 on success).
// ext_id 0 (NoExt) takes the reset cache (R >= 1; scal, cscal, planes,
// cplanes and seeds unused); a cached ext takes the cache with its K extra
// scalars (cscal) and P extra planes (cplanes) and its live ones (scal,
// planes); a counter-reset ext takes seeds and K extra scalars (R = 0, no
// cache).
extern "C" int fused_rollout_launch(const int* actions, int* grid, int* cont, int* sc, int* mis,
                                    const int* cgrid, const int* ccont, const int* csc,
                                    const int* cmis, const int* cscal, int* scal, uint8_t* planes,
                                    const uint8_t* cplanes, const int* seeds, int* used,
                                    int* obs, float* rew, int* done, int W, int H, int V, int R,
                                    int M, int T, int N, int K, int P, int no_objects,
                                    int static_mission, int see_through, int compute_obs,
                                    int ext_id, int max_steps, int n_obstacles, int num_crossings,
                                    int obstacle_cell, int start_x, int start_y, int start_dir,
                                    void* stream) {
  if (V != 7 || W < 1 || H < 1 || M < 0 || T < 0 || N < 0 || K < 0 || P < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const ExtParams p{max_steps, n_obstacles, num_crossings, obstacle_cell, start_x, start_y, start_dir};
  const Args a{actions, grid, cont, sc, mis, cgrid, ccont, csc, cmis, cscal, scal, planes, cplanes, seeds,
               used, obs, rew, done, W, H, R, M, T, N, K, P};
  const int flags[4] = {no_objects, static_mission, see_through, compute_obs};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool ok = false;
  with_ext(ext_id, [&](auto ext) {
    using Ext = decltype(ext);
    ok = ext_launch_ok<Ext>(ext_id, p, W, H, R, K, P, flags, scal, cscal, seeds, planes, cplanes);
    if (ok && N > 0) dispatch<7, Ext>(a, p, flags, st);
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  return N == 0 ? (int)cudaSuccess : (int)cudaGetLastError();
}
