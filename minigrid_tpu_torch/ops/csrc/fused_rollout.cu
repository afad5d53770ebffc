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
// Design.  One thread runs one env through all T steps; the transition,
// the cache reset and the view are the device functions of minigrid_env.cuh,
// which the actor kernel (actor_rollout.cu) shares.  Every array is
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
// Bit-exactness with the JAX package: the per-env checksum is accumulated in
// uint32 so that it wraps as int32 does in JAX.

#include <cuda_runtime.h>
#include <stdint.h>

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

template <int V, bool NO_OBJECTS, bool STATIC_MISSION, bool SEE_THROUGH, bool COMPUTE_OBS>
__global__ void __launch_bounds__(THREADS) rollout_kernel(const Args a) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= a.N) return;
  const size_t N = (size_t)a.N;
  const int W = a.W, H = a.H, WH = a.W * a.H;
  const Cache cache{a.cgrid, a.ccont, a.csc, a.cmis, a.R};

  // This env's column of every env-minor array: element k at [k * N].
  int* grid = a.grid + n;
  int* cont = a.cont + n;
  int* sc = a.sc + n;
  int* mis = a.mis + n;
  const int* act = a.actions + n;

  Scalars s = load_scalars(sc, N);
  int used = 0, done_count = 0;
  uint32_t obs_sum = 0;
  float rew_sum = 0.0f;

  for (int t = 0; t < a.T; ++t) {
    const float reward = core_step<NO_OBJECTS>(grid, cont, N, W, H, s, act[(size_t)t * N]);
    const bool done = s.term || s.trunc;
    rew_sum += reward;
    done_count += done;
    if (done) {
      cache_reset<NO_OBJECTS, STATIC_MISSION>(cache, n, used, grid, cont, mis, N, WH, a.M, s);
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
