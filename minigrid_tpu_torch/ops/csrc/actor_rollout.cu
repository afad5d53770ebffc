// Whole-collection actor kernel for Hopper (sm_90a): the policy inside the
// environment loop.
//
// Replaces the Pallas TPU kernel minigrid_tpu/ops/actor_rollout.py::_actor_kernel.
// For T steps, every env observes its state (the packed view with
// occlusion, unseen cells 0), embeds it as one-hots, runs the actor MLP
// (bf16 weights, f32 accumulation), samples the action by Gumbel-argmax
// from injected random bits, then runs the family's pre-step hook, the
// core step on the mapped action and the post-step hook on the unmapped
// one (on a StepCtx of the transition), and auto-resets: from the R-slot
// reset cache (NoExt families and the cached exts, whose extra scalars and
// planes come from the same slot; core/env.step_cached semantics) or, for a
// COUNTER_RESET ext, by generating a fresh level in place from the env's
// seed and episode ordinal (both at the pre-increment `used`).  It streams obs, direction, the
// unmapped action, logp, value, reward and done.
//
// Design.  A block owns B = 32 envs and has HID threads (one per hidden
// unit).  Per step:
//   1. warp 0, one lane per env, builds the view through minigrid_env.cuh
//      (shared with fused_rollout.cu) into shared memory; the block then
//      stores the [32, V*V] obs tile to the [T, N, V*V] output, coalesced;
//   2. layer 1 is a gather-sum, as in embed_dense.cu: thread h adds the
//      3*V*V + 1 rows of W1 [V*V*20+4, HID] that each env selects (f32),
//      then, as the TPU kernel does (actor_rollout.py:120-121), adds f32 b1,
//      applies ReLU and rounds to bf16;
//   3. layer 2: thread h computes column h for all 32 envs, h2 = bf16(ReLU(
//      h1 @ W2 + b2)) with W2 [HID, HID] (flax [in, out] layout, bf16) read
//      through L1 and h1 from shared memory as 16-byte broadcasts;
//   4. heads: a warp per env, lanes over the hidden units, one shuffle
//      reduction per head row (NA logits, then the value), + f32 bias;
//   5. warp 0 samples (u = (bits[31:8] + 0.5) / 2^24, z = lg - log(-log u),
//      first maximum wins; logp = lg[a] - logsumexp(lg), with accurate
//      logf/expf), then steps and resets its env through the family's Ext
//      struct (fused_ext.cuh and ext/*.cuh, the same structs as the
//      random-policy kernel; ext_id picks the instantiation).
// Activations live in shared memory env-major ([32][HID] f32 holding bf16
// values), so the layer-1 and layer-2 stores and the head reads are free
// of bank conflicts.  The family's extra state (Ext::Extra, up to 19 ints
// for Dynamic-Obstacles) also lives in shared memory, one slot per env:
// only warp 0 touches it, and in registers it would be allocated to all
// HID threads, against __launch_bounds__(HID, 2)'s cap of 128 registers at
// HID = 256 that layer 2's 32 accumulators already press on.  The seeds,
// and a cached ext's scalars of the cache slot, are read from device memory
// at each reset straight into that slot, so no register holds them across
// the loop.  An ext's extra planes (BabyAI's verifier: two planes of W*H
// bytes per env, 968 bytes at 22x22) stay in device memory, env-minor as
// the grid is ([P, W*H, N]): in shared memory they would take 31 KB per
// block at 22x22, against the two blocks per SM that __launch_bounds__
// asks for.
//
// What bounds it on this card.  Layer 2 is 32 x HID x HID FMAs per block
// step on the CUDA cores (67 Mi FMA per step of 8192 envs at HID = 256);
// layer 1 is 148 two-byte L1/L2 loads per env per thread.  Both are far
// from the tensor cores' rate: mma.sync or wgmma on [32, HID] x [HID, HID]
// tiles, and a wider load per thread in layer 1, are the next steps.  The
// env phase runs on one warp of the block while the others wait; a
// counter reset (Dynamic-Obstacles scans the grid twice per ball) holds
// the whole block at the next barrier.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "exts.cuh"
#include "minigrid_env.cuh"

namespace {

using namespace minigrid;

constexpr int B = 32;          // envs per block (one per lane of warp 0)
constexpr int MAX_HEADS = 8;   // NA logits + 1 value, NA <= 7

struct Args {
  const int* noise;          // [T, NA, N] random bits
  int* grid;                 // [W*H, N]  in: initial state, out: final state
  int* cont;                 // [W*H, N]
  int* sc;                   // [NUM_SC, N]
  int* mis;                  // [M, N]
  const int* cgrid;          // [R, W*H, N]
  const int* ccont;          // [R, W*H, N]
  const int* csc;            // [R, NUM_SC, N]
  const int* cmis;           // [R, M, N]
  const int* cscal;          // [R, K, N] (cached exts)
  int* scal;                 // [K, N] the ext's extra scalars, in and out
  uint8_t* planes;           // [P, W*H, N] the ext's extra planes, in and out
  const uint8_t* cplanes;    // [R, P, W*H, N] (cached exts with planes)
  const int* seeds;          // [2, N] counter-reset seeds (COUNTER_RESET exts)
  const __nv_bfloat16* w1;   // [V*V*20 + 4, HID]
  const float* b1;           // [HID]
  const __nv_bfloat16* w2;   // [HID, HID]
  const float* b2;           // [HID]
  const __nv_bfloat16* wh;   // [NA + 1, HID]: logit rows, then the value row
  const float* bh;           // [NA + 1]
  int* obs;                  // [T, N, V*V]
  int* dir;                  // [T, N]
  int* act;                  // [T, N]
  float* logp;               // [T, N]
  float* value;              // [T, N]
  float* rew;                // [T, N]
  uint8_t* done;             // [T, N]
  int W, H, R, M, T, N, K, P, NA;
};

__device__ __forceinline__ float bf(const __nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float round_bf16(float x) { return bf(__float2bfloat16_rn(x)); }

template <int V, int HID, class Ext, bool NO_OBJECTS, bool STATIC_MISSION, bool SEE_THROUGH>
__global__ void __launch_bounds__(HID, 2) actor_kernel(const Args a, const ExtParams p) {
  static_assert(!Ext::COUNTER_RESET || (NO_OBJECTS && STATIC_MISSION),
                "a counter reset writes neither contents nor mission");
  constexpr int V2 = V * V;
  constexpr int NWARPS = HID / 32;
  __shared__ int obs_s[B * V2];
  __shared__ int dir_s[B];
  __shared__ __align__(16) float h_s[B * HID];  // [env][hidden]
  __shared__ float head_s[B * MAX_HEADS];
  __shared__ typename Ext::Extra x_s[B];        // warp 0's envs' extra state

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t N = (size_t)a.N;
  const int n0 = blockIdx.x * B;
  const bool env_thread = warp == 0;  // lane owns env n0 + lane
  const int n = n0 + lane;
  const int WH = a.W * a.H;
  const int na = a.NA;
  const Cache cache{a.cgrid, a.ccont, a.csc, a.cmis, a.cscal, a.cplanes, a.R, a.K, a.P};
  int* grid = a.grid + n;
  int* cont = a.cont + n;
  int* mis = a.mis + n;
  uint8_t* planes = Ext::NUM_PLANES > 0 ? a.planes + n : nullptr;

  Scalars s{};
  int used = 0;
  if (env_thread) {
    s = load_scalars(a.sc + n, N);
    x_s[lane] = Ext::load(a.scal, n, N, p);
  }
  const int h = tid;
  const float b1h = a.b1[h];
  const float b2h = a.b2[h];

  for (int t = 0; t < a.T; ++t) {
    const size_t tn = (size_t)t * N;

    // 1. Observe the current state.
    if (env_thread) {
      int view[V][V];
      view_cells<V>(grid, N, a.W, a.H, s, view);
      hide_unseen<V, SEE_THROUGH>(view);
#pragma unroll
      for (int i = 0; i < V; ++i)
#pragma unroll
        for (int j = 0; j < V; ++j) obs_s[lane * V2 + i * V + j] = view[i][j];
      dir_s[lane] = s.d;
      a.dir[tn + n] = s.d;
    }
    __syncthreads();
    int* obs_dst = a.obs + (tn + n0) * V2;
    for (int k = tid; k < B * V2; k += HID) obs_dst[k] = obs_s[k];

    // 2. Layer 1: gather-sum of the selected W1 rows, + b1, ReLU, bf16.
    for (int e = 0; e < B; ++e) {
      float acc = 0.f;
      const int* pe = obs_s + e * V2;
#pragma unroll 7
      for (int slot = 0; slot < V2; ++slot) {
        const CellRows r = cell_rows(pe[slot], slot);
        if (r.type >= 0) acc += bf(a.w1[(size_t)r.type * HID + h]);
        if (r.color >= 0) acc += bf(a.w1[(size_t)r.color * HID + h]);
        acc += bf(a.w1[(size_t)r.state * HID + h]);
      }
      const int d = direction_row(dir_s[e], V2);
      if (d >= 0) acc += bf(a.w1[(size_t)d * HID + h]);
      h_s[e * HID + h] = round_bf16(fmaxf(acc + b1h, 0.f));
    }
    __syncthreads();

    // 3. Layer 2: column h for every env.
    float acc2[B];
#pragma unroll
    for (int e = 0; e < B; ++e) acc2[e] = 0.f;
    for (int k = 0; k < HID; k += 4) {
      const float w0 = bf(a.w2[(size_t)(k + 0) * HID + h]);
      const float w1 = bf(a.w2[(size_t)(k + 1) * HID + h]);
      const float w2 = bf(a.w2[(size_t)(k + 2) * HID + h]);
      const float w3 = bf(a.w2[(size_t)(k + 3) * HID + h]);
#pragma unroll
      for (int e = 0; e < B; ++e) {
        const float4 x = *reinterpret_cast<const float4*>(h_s + e * HID + k);
        acc2[e] = fmaf(x.x, w0, acc2[e]);
        acc2[e] = fmaf(x.y, w1, acc2[e]);
        acc2[e] = fmaf(x.z, w2, acc2[e]);
        acc2[e] = fmaf(x.w, w3, acc2[e]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < B; ++e) h_s[e * HID + h] = round_bf16(fmaxf(acc2[e] + b2h, 0.f));
    __syncthreads();

    // 4. Heads: warp per env, lanes over the hidden units.
    for (int e = warp; e < B; e += NWARPS) {
      float part[MAX_HEADS];
#pragma unroll
      for (int r = 0; r < MAX_HEADS; ++r) part[r] = 0.f;
      for (int k = lane; k < HID; k += 32) {
        const float x = h_s[e * HID + k];
#pragma unroll
        for (int r = 0; r < MAX_HEADS; ++r) {
          if (r <= na) part[r] = fmaf(x, bf(a.wh[(size_t)r * HID + k]), part[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < MAX_HEADS; ++r) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) part[r] += __shfl_xor_sync(0xffffffffu, part[r], off);
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < MAX_HEADS; ++r) {
          if (r <= na) head_s[e * MAX_HEADS + r] = part[r] + a.bh[r];
        }
      }
    }
    __syncthreads();

    // 5. Sample, then step and auto-reset.
    if (env_thread) {
      float lg[MAX_HEADS - 1];
#pragma unroll
      for (int k = 0; k < MAX_HEADS - 1; ++k) lg[k] = k < na ? head_s[lane * MAX_HEADS + k] : 0.f;
      const float value = head_s[lane * MAX_HEADS + na];
      int action = 0;
      float best = 0.f;
      float m = lg[0];
#pragma unroll
      for (int k = 0; k < MAX_HEADS - 1; ++k) {
        if (k < na) {
          const uint32_t bits = (uint32_t)a.noise[((size_t)t * na + k) * N + n];
          const float u = ((float)((bits >> 8) & 0xFFFFFFu) + 0.5f) * (1.0f / 16777216.0f);
          const float z = lg[k] + -logf(-logf(u));
          if (k == 0 || z > best) {
            best = z;
            action = k;
          }
          m = fmaxf(m, lg[k]);
        }
      }
      float se = 0.f;
      float chosen = 0.f;
#pragma unroll
      for (int k = 0; k < MAX_HEADS - 1; ++k) {
        if (k < na) se += expf(lg[k] - m);
        if (k == action) chosen = lg[k];
      }
      a.act[tn + n] = action;
      a.logp[tn + n] = chosen - (m + logf(se));
      a.value[tn + n] = value;

      typename Ext::Extra& x = x_s[lane];
      if constexpr (Ext::PRE_STEP) Ext::pre_step(p, grid, planes, N, a.W, a.H, s, x);
      const Scalars prev = s;
      const Cell f = front_cell(prev, a.W, a.H);
      const int front = f.x * a.H + f.y;
      const int front_before = Ext::FRONT_BEFORE ? grid[(size_t)front * N] : 0;
      float reward = core_step<NO_OBJECTS>(grid, cont, N, a.W, a.H, s, Ext::map_action(action));
      const StepCtx ctx{grid, cont, N, a.W, a.H, prev, s, action, front, front_before, planes};
      if (Ext::post_step(p, ctx, reward, x)) s.term = 1;
      const bool done = s.term || s.trunc;
      a.rew[tn + n] = reward;
      a.done[tn + n] = done;
      if (done) {
        if constexpr (Ext::COUNTER_RESET) {
          const Words e = episode_seed((uint32_t)a.seeds[n], (uint32_t)a.seeds[N + n], used);
          Ext::reset(p, e, grid, N, a.W, a.H, s, x);
        } else {
          cache_reset<Ext, NO_OBJECTS, STATIC_MISSION>(cache, p, n, used, grid, cont, mis, planes, N, WH, a.M, s, x);
        }
        used += 1;
      }
    }
  }
  if (env_thread) {
    store_scalars(a.sc + n, N, s);
    Ext::store(a.scal, n, N, p, x_s[lane]);
  }
}

// Picks the instantiation for the runtime switches, one flag at a time;
// `flags` are NO_OBJECTS, STATIC_MISSION, SEE_THROUGH.  A switch the ext
// fixes (ext_switch) takes its value, not the flag's, as in the
// random-policy kernel.
template <int V, int HID, class Ext, bool... Fixed>
void dispatch(const Args& a, const ExtParams& p, const int* flags, cudaStream_t stream) {
  constexpr int i = sizeof...(Fixed);
  if constexpr (i == 3) {
    actor_kernel<V, HID, Ext, Fixed...><<<a.N / B, HID, 0, stream>>>(a, p);
  } else if constexpr (ext_switch<Ext>(i) != SWITCH_ANY) {
    dispatch<V, HID, Ext, Fixed..., ext_switch<Ext>(i) == 1>(a, p, flags, stream);
  } else {
    if (flags[i]) {
      dispatch<V, HID, Ext, Fixed..., true>(a, p, flags, stream);
    } else {
      dispatch<V, HID, Ext, Fixed..., false>(a, p, flags, stream);
    }
  }
}

}  // namespace

// Hidden sizes with an instantiation: the PPO configuration's 256 and the
// narrow 64 of the tests.
extern "C" int actor_rollout_supports_hidden(int hidden) { return hidden == 256 || hidden == 64; }

// Launches the collection on `stream`; returns a cudaError_t (0 on success).
// ext_id 0 (NoExt) takes the reset cache (R >= 1; scal, cscal, planes,
// cplanes and seeds unused); a cached ext takes the cache with its K extra
// scalars (cscal) and P extra planes (cplanes) and its live ones (scal,
// planes); a counter-reset ext takes seeds and K extra scalars (R = 0, no
// cache).
extern "C" int actor_rollout_launch(const int* noise, int* grid, int* cont, int* sc, int* mis,
                                    const int* cgrid, const int* ccont, const int* csc,
                                    const int* cmis, const int* cscal, int* scal, uint8_t* planes,
                                    const uint8_t* cplanes, const int* seeds,
                                    const void* w1,
                                    const float* b1, const void* w2, const float* b2,
                                    const void* wh, const float* bh, int* obs, int* dir, int* act,
                                    float* logp, float* value, float* rew, void* done, int W,
                                    int H, int V, int R, int M, int T, int N, int K, int P, int NA,
                                    int hidden, int no_objects, int static_mission,
                                    int see_through, int ext_id, int max_steps, int n_obstacles,
                                    int num_crossings, int obstacle_cell, int start_x, int start_y,
                                    int start_dir, void* stream) {
  if (V != 7 || W < 1 || H < 1 || M < 0 || T < 0 || N < 0 || N % B != 0 || K < 0 || P < 0 || NA < 1 ||
      NA > MAX_HEADS - 1 || !actor_rollout_supports_hidden(hidden)) {
    return (int)cudaErrorInvalidValue;
  }
  const ExtParams p{max_steps, n_obstacles, num_crossings, obstacle_cell, start_x, start_y, start_dir};
  const Args a{noise, grid, cont, sc, mis, cgrid, ccont, csc, cmis, cscal, scal, planes, cplanes, seeds,
               static_cast<const __nv_bfloat16*>(w1), b1,
               static_cast<const __nv_bfloat16*>(w2), b2,
               static_cast<const __nv_bfloat16*>(wh), bh,
               obs, dir, act, logp, value, rew, static_cast<uint8_t*>(done),
               W, H, R, M, T, N, K, P, NA};
  const int flags[3] = {no_objects, static_mission, see_through};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  with_ext(ext_id, [&](auto ext) {
    using Ext = decltype(ext);
    ok = ext_launch_ok<Ext>(ext_id, p, W, H, R, K, P, flags, scal, cscal, seeds, planes, cplanes);
    if (!ok || N == 0) return;
    if (hidden == 256) {
      dispatch<7, 256, Ext>(a, p, flags, s);
    } else {
      dispatch<7, 64, Ext>(a, p, flags, s);
    }
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  return N == 0 ? (int)cudaSuccess : (int)cudaGetLastError();
}
