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
// cached ext's extra scalars from the same slot (NoExt, GoToTarget, Fetch,
// the classic families' exts, and BabyAI with its verifier's two planes), or, for a
// COUNTER_RESET ext, generates a fresh level in place from the env's seed
// and episode ordinal `used` (ext.reset_block); both use the pre-increment
// `used`.
//
// Design.  One thread owns one env through all T steps and runs the
// per-env work: the pre-step hook, the core transition and the post-step
// hook (the device functions of minigrid_env.cuh, which the actor kernel
// actor_rollout.cu shares, and an Ext struct of fused_ext.cuh, one header
// per family under ext/, picked at launch by ext_id), and the view.  Every
// reset is done by the whole warp: after the step, __ballot_sync collects
// the lanes whose episode ended, and for each of them in turn the 32 lanes
// copy that env's cache slot min(used, R-1) (grid, contents, mission,
// byte planes) or, for a COUNTER_RESET ext, make its fresh level
// (Ext::warp_reset: the scaffold written and the free cells scanned 32 at a
// time, the threefry draws on the owner's seed and episode ordinal; an ext
// without a warp form, WARP_RESET false, has each ended env's lane run its
// per-lane Ext::reset on its own rows instead, while the other lanes wait);
// the owner then loads the level's 8 scalar rows and the ext's extra scalars
// after a __syncwarp().  Lanes past N stay in the loop, inactive, so the
// full-warp ballots and copies are defined; a warp wholly past N returns.
//
// Layouts.  Each array is read where the caller's state and reset cache
// hold it, so the wrapper copies neither: grid and contents [N, W*H] (the
// state's [N, W, H], cloned once, updated in place), the 8 scalar rows
// [8, N], mission [N, M], the ext's extra scalars [N, K] and byte planes
// [N, P, W*H], seeds [N, 2]; the cache as batch_reset_cache returns it,
// [N, R, W*H] grid and contents, [N, R, M] mission, [N, R] for each
// scalar field, [N, R, K] extra scalars, [N, R, P, W*H] planes; actions
// [T, N].  An env's cells are contiguous, so the per-env device
// functions run on its row with cell stride 1, and a level is one
// contiguous run on either side of the copy: each warp access is whole
// lines, in 16-byte vectors where the row allows.  NO_OBJECTS,
// STATIC_MISSION, SEE_THROUGH and COMPUTE_OBS are compile-time switches, as
// in the TPU kernel; the view size V is a template parameter: the built-in
// library instantiates 7, and a library built for one family at another
// odd V from 3 to 31 (ops/_build.Shape: -DMINIGRID_VIEW, and
// -DMINIGRID_ONLY_EXT for the family's ext) holds that V alone.  Views up
// to 7 hold their V x V cells in registers; a wider one takes its rows' lit
// masks first (view_lit) and then reads the cells they light, from L1.  An
// ext is instantiated only at the switches its SWITCHES fixes (the
// built-in counter-reset exts without objects and with a constant mission;
// a counter reset that writes contents, a mission or planes gets them as a
// ResetCtx of the env's rows; GoToTarget, Fetch and PutNear with objects,
// a per-episode mission and see-through walls; BabyAI and the RoomGrid,
// Memory and RedBlueDoors exts with objects, a per-episode mission and
// occluding walls); ext_launch_ok refuses other flags.
//
// What bounds it.  The bytes it must move are the actions, the state in
// and out and the levels its resets read (chip_smoke.rollout_bytes); per
// step a lane does a handful of integer operations around a few
// data-dependent loads inside its env's row (the front cell, and with
// COMPUTE_OBS the V*V view cells, through L1), and per reset the warp
// moves one level, W*H words and the rest, in whole lines, where the
// per-lane copy it replaces gathered one word per 32-byte sector and ran
// once per resetting lane while the other 31 waited.  Dynamic-Obstacles'
// walk (9 loads and 2 stores per ball, a threefry per two balls) and
// BabyAI's verifier (6 byte loads, and a W*H-byte copy of gridm into poss on
// a drop) stay per lane, but for BabyAI's copy, which the warp makes after
// the hooks (POSS_ON_DROP).  BabyAI's bench size is 16384 envs, 4 warps a SM,
// so its time is the latency of one env's chain of T steps, not the card's
// throughput (tools/rollout_split.py measures the phases).
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

#ifndef MINIGRID_VIEW
#define MINIGRID_VIEW 7
#endif
static_assert(MINIGRID_VIEW >= 3 && MINIGRID_VIEW <= 31 && MINIGRID_VIEW % 2 == 1, "an odd view from 3 to 31");

// The phases of a step that tools/rollout_split.py times: it builds a copy
// of this file with SPLIT_BEGIN, SPLIT_MARK, SPLIT_SYNC and SPLIT_END
// defined as per-lane clock64() sums (SPLIT_SYNC puts a __syncwarp() first,
// so that a lane's wait for the rest of its warp is a phase of its own).
// Here they compile to nothing.
enum SplitPhase { PH_PRE, PH_STEP, PH_POST, PH_WAIT, PH_RESET, PH_OBS };
#ifndef SPLIT_MARK
#define SPLIT_BEGIN()
#define SPLIT_MARK(phase)
#define SPLIT_SYNC(phase)
#define SPLIT_END(active)
#endif

// The reset cache's scalar fields, each [N, R] as the cache holds them:
// six int32, and the two flags as bytes (torch.bool).
struct CacheRows {
  const int *ax, *ay, *dir, *carry, *step, *max_steps;
  const uint8_t *term, *trunc;
};

struct Args {
  const int* actions;      // [T, N]
  int* grid;               // [N, W*H]  in: initial state, out: final state
  int* cont;               // [N, W*H]
  int* sc;                 // [NUM_SC, N]
  int* mis;                // [N, M]
  const int* cgrid;        // [N, R, W*H]  (cached families)
  const int* ccont;        // [N, R, W*H]
  CacheRows csc;           // the cache's 8 scalar fields, each [N, R]
  const int* cmis;         // [N, R, M]
  const int* cscal;        // [N, R, K] (cached exts)
  int* scal;               // [N, K] the ext's extra scalars, in and out
  uint8_t* planes;         // [N, P, W*H] the ext's extra planes, in and out
  const uint8_t* cplanes;  // [N, R, P, W*H] (cached exts with planes)
  const int* seeds;        // [N, 2] counter-reset seeds (COUNTER_RESET exts)
  int* used;               // [N] resets so far (cache slots consumed)
  int* obs;                // [N] observation checksum (int32 wraparound)
  float* rew;              // [N] reward sum
  int* done;               // [N] episodes ended
  int W, H, R, M, T, N, K, P;
};

// A level's copy by the 32 lanes of a warp, as segments (grid, contents,
// mission, planes): each a contiguous run copied in units of 16 bytes, a
// word or a byte, the widest that both ends and the size allow; unit i of
// a segment goes to lane i % 32.  A lane issues its loads of every segment
// for a round (ROUND units each) before its stores, so that a level's copy
// takes one round of memory latency per 32 * ROUND units of its largest
// segment, and every access of the warp is whole lines.  A round is held
// in 16-byte registers: four for one segment, two a segment for more (on
// the H100 eight for one segment cost the rollout kernel's smaller
// instantiations registers and spills, and BabyAI's time).

struct Segment {
  void* dst;
  const void* src;
  int units, width;
};

__device__ __forceinline__ Segment segment(void* dst, const void* src, int bytes) {
  const uintptr_t align = (uintptr_t)dst | (uintptr_t)src | (uintptr_t)bytes;
  const int width = (align & 15) == 0 ? 16 : (align & 3) == 0 ? 4 : 1;
  return Segment{dst, src, bytes / width, width};
}

__device__ __forceinline__ int4 load_unit(const Segment& g, int i) {
  if (g.width == 16) return __ldcs(static_cast<const int4*>(g.src) + i);
  if (g.width == 4) return make_int4(__ldcs(static_cast<const int*>(g.src) + i), 0, 0, 0);
  return make_int4(static_cast<const uint8_t*>(g.src)[i], 0, 0, 0);
}

__device__ __forceinline__ void store_unit(const Segment& g, int i, const int4& v) {
  if (g.width == 16) {
    static_cast<int4*>(g.dst)[i] = v;
  } else if (g.width == 4) {
    static_cast<int*>(g.dst)[i] = v.x;
  } else {
    static_cast<uint8_t*>(g.dst)[i] = (uint8_t)v.x;
  }
}

template <int NSEG>
__device__ __forceinline__ void warp_copy(const Segment (&g)[NSEG], int lane) {
  constexpr int ROUND = NSEG == 1 ? 4 : 2;
  int most = 0;
#pragma unroll
  for (int k = 0; k < NSEG; ++k) most = max(most, g[k].units);
  for (int i0 = lane; i0 < most; i0 += 32 * ROUND) {
    int4 v[NSEG][ROUND];
#pragma unroll
    for (int k = 0; k < NSEG; ++k)
#pragma unroll
      for (int u = 0; u < ROUND; ++u) {
        if (i0 + 32 * u < g[k].units) v[k][u] = load_unit(g[k], i0 + 32 * u);
      }
#pragma unroll
    for (int k = 0; k < NSEG; ++k)
#pragma unroll
      for (int u = 0; u < ROUND; ++u) {
        if (i0 + 32 * u < g[k].units) store_unit(g[k], i0 + 32 * u, v[k][u]);
      }
  }
}

// Where a counter reset writes env e's level: its rows (stride 1), the
// contents, mission and planes only where the instantiation carries them.
template <bool NO_OBJECTS, bool STATIC_MISSION, int P>
__device__ __forceinline__ ResetCtx reset_rows(const Args& a, size_t e, int W, int H, int M) {
  const int WH = W * H;
  return ResetCtx{a.grid + e * WH, NO_OBJECTS ? nullptr : a.cont + e * WH, STATIC_MISSION ? nullptr : a.mis + e * M,
                  P == 0 ? nullptr : a.planes + e * P * WH, 1, W, H, M};
}

template <int V, class Ext, bool NO_OBJECTS, bool STATIC_MISSION, bool SEE_THROUGH, bool COMPUTE_OBS>
__global__ void __launch_bounds__(THREADS) rollout_kernel(const Args a, const ExtParams p) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int base = n - lane;  // the warp's first env
  if (base >= a.N) return;
  const bool active = n < a.N;
  const size_t N = (size_t)a.N;
  const int W = a.W, H = a.H, WH = a.W * a.H, R = a.R, M = a.M, K = a.K;
  constexpr int P = Ext::NUM_PLANES;

  // This env's rows (an inactive lane takes the warp's first env's and
  // never reads or writes them).
  const size_t me = active ? (size_t)n : (size_t)base;
  int* grid = a.grid + me * WH;
  int* cont = a.cont + me * WH;
  uint8_t* planes = P > 0 ? a.planes + me * P * WH : nullptr;

  Scalars s{};
  typename Ext::Extra x{};
  uint32_t seed0 = 0, seed1 = 0;
  if (active) {
    s = load_scalars(a.sc + n, N);
    x = Ext::load(a.scal + me * K, 0, 1, p);
    if constexpr (Ext::COUNTER_RESET) {
      seed0 = (uint32_t)a.seeds[2 * me];
      seed1 = (uint32_t)a.seeds[2 * me + 1];
    }
  }
  int used = 0, done_count = 0;
  uint32_t obs_sum = 0;
  float rew_sum = 0.0f;

  SPLIT_BEGIN();
  for (int t = 0; t < a.T; ++t) {
    bool done = false;
    const int action = active ? a.actions[(size_t)t * N + n] : -1;
    if (active) {
      if constexpr (Ext::PRE_STEP) Ext::pre_step(p, grid, planes, 1, W, H, s, x);
      SPLIT_MARK(PH_PRE);
      const Scalars prev = s;
      const Cell f = front_cell(prev, W, H);
      const int front = f.x * H + f.y;
      const int front_before = Ext::FRONT_BEFORE ? grid[front] : 0;
      float reward = core_step<NO_OBJECTS>(grid, cont, 1, W, H, s, Ext::map_action(action));
      SPLIT_MARK(PH_STEP);
      const StepCtx ctx{grid, cont, 1, W, H, prev, s, action, front, front_before, planes};
      bool ended;
      if constexpr (Ext::POSS_ON_DROP) {
        ended = Ext::template verify<true>(p, ctx, reward, x);
      } else {
        ended = Ext::post_step(p, ctx, reward, x);
      }
      if (ended) s.term = 1;
      done = s.term || s.trunc;
      rew_sum += reward;
      done_count += done;
      SPLIT_MARK(PH_POST);
    }
    SPLIT_SYNC(PH_WAIT);
    if constexpr (Ext::POSS_ON_DROP) {
      // The hooks' poss = gridm copies of this step's drops, a warp each.
      const unsigned drops = __ballot_sync(FULL_WARP, action == ACT_DROP);
      if (drops != 0) {
        __syncwarp();
        for (unsigned m = drops; m != 0; m &= m - 1) {
          uint8_t* gridm = a.planes + ((size_t)base + __ffs(m) - 1) * P * WH;
          const Segment copy[1] = {segment(gridm + WH, gridm, WH)};
          warp_copy(copy, lane);
        }
        __syncwarp();
      }
      SPLIT_MARK(PH_POST);
    }
    const unsigned resets = __ballot_sync(FULL_WARP, done);
    if (resets != 0) {
      __syncwarp();  // each lane's step is written before other lanes rewrite its rows
      if constexpr (Ext::COUNTER_RESET && !Ext::WARP_RESET) {
        // No warp form: each ended env's lane makes its level on its own
        // rows while the other lanes wait.
        if (done) {
          const ResetCtx rc = reset_rows<NO_OBJECTS, STATIC_MISSION, P>(a, me, W, H, M);
          Ext::reset(p, episode_seed(seed0, seed1, used), rc, s, x);
        }
      } else {
        for (unsigned m = resets; m != 0; m &= m - 1) {
          const int src = __ffs(m) - 1;
          const size_t e = (size_t)base + src;
          const int u = __shfl_sync(FULL_WARP, used, src);
          if constexpr (Ext::COUNTER_RESET) {
            const uint32_t s0 = __shfl_sync(FULL_WARP, seed0, src), s1 = __shfl_sync(FULL_WARP, seed1, src);
            Scalars sr = s;
            typename Ext::Extra xr = x;
            const ResetCtx rc = reset_rows<NO_OBJECTS, STATIC_MISSION, P>(a, e, W, H, M);
            Ext::warp_reset(p, episode_seed(s0, s1, u), rc, sr, xr, lane);
            if (lane == src) {
              s = sr;
              x = xr;
            }
          } else {
            const size_t level = e * R + min(u, R - 1);
            const Segment grid_seg = segment(a.grid + e * WH, a.cgrid + level * WH, WH * 4);
            if constexpr (NO_OBJECTS && STATIC_MISSION && P == 0) {
              const Segment copy[1] = {grid_seg};
              warp_copy(copy, lane);
            } else {
              const Segment copy[4] = {
                  grid_seg,
                  NO_OBJECTS ? Segment{} : segment(a.cont + e * WH, a.ccont + level * WH, WH * 4),
                  STATIC_MISSION ? Segment{} : segment(a.mis + e * M, a.cmis + level * M, M * 4),
                  P == 0 ? Segment{} : segment(a.planes + e * P * WH, a.cplanes + level * P * WH, P * WH),
              };
              warp_copy(copy, lane);
            }
          }
        }
      }
      __syncwarp();  // the new levels are in before their owners read them
      if (done) {
        if constexpr (!Ext::COUNTER_RESET) {
          const size_t level = me * R + min(used, R - 1);
          const CacheRows& c = a.csc;
          s = Scalars{c.ax[level],        c.ay[level],        c.dir[level],  c.carry[level],
                      c.step[level],      c.max_steps[level], c.term[level], c.trunc[level]};
          if constexpr (Ext::MAX_K > 0) x = Ext::load(a.cscal + level * K, 0, 1, p);
        }
        used += 1;
      }
    }
    SPLIT_MARK(PH_RESET);
    SPLIT_SYNC(PH_WAIT);
    if (COMPUTE_OBS && active) {
      // Sum of the visible packed cells (_obs_checksum_block).
      if constexpr (V <= 7) {
        int view[V][V];
        view_cells<V>(grid, 1, W, H, s, view);
        hide_unseen<V, SEE_THROUGH>(view);
#pragma unroll
        for (int i = 0; i < V; ++i)
#pragma unroll
          for (int j = 0; j < V; ++j) obs_sum += (uint32_t)view[i][j];
      } else {
        // A wider view: the rows' lit masks, then the cells they light.
        const ViewFrame f = view_frame(s.ax, s.ay, s.d);
        uint32_t lit[V];
        view_lit<V, SEE_THROUGH>(grid, 1, W, H, f, s.carry, lit);
#pragma unroll 1
        for (int i = 0; i < V; ++i)
#pragma unroll
          for (int j = 0; j < V; ++j) {
            if ((lit[j] >> i) & 1u) obs_sum += (uint32_t)view_value<V>(grid, 1, W, H, f, s.carry, i, j);
          }
      }
    }
    SPLIT_MARK(PH_OBS);
  }
  SPLIT_END(active);

  if (!active) return;
  store_scalars(a.sc + n, N, s);
  Ext::store(a.scal + me * K, 0, 1, p, x);
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

// The view size this library holds.
extern "C" int fused_rollout_view() { return MINIGRID_VIEW; }

// Launches the rollout on `stream`; returns a cudaError_t (0 on success).
// ext_id 0 (NoExt) takes the reset cache (R >= 1; scal, cscal, planes,
// cplanes and seeds unused); a cached ext takes the cache with its K extra
// scalars (cscal) and P extra planes (cplanes) and its live ones (scal,
// planes); a counter-reset ext takes seeds and K extra scalars (R = 0, no
// cache), and writes its P planes at each reset.  user0..3 are a user
// family's ExtParams::user slots.  The layouts are Args'.
extern "C" int fused_rollout_launch(const int* actions, int* grid, int* cont, int* sc, int* mis,
                                    const int* cgrid, const int* ccont, const int* c_ax, const int* c_ay,
                                    const int* c_dir, const int* c_carry, const int* c_step,
                                    const int* c_max_steps, const uint8_t* c_term, const uint8_t* c_trunc,
                                    const int* cmis, const int* cscal, int* scal, uint8_t* planes,
                                    const uint8_t* cplanes, const int* seeds, int* used,
                                    int* obs, float* rew, int* done, int W, int H, int V, int R,
                                    int M, int T, int N, int K, int P, int no_objects,
                                    int static_mission, int see_through, int compute_obs,
                                    int ext_id, int max_steps, int n_obstacles, int num_crossings,
                                    int obstacle_cell, int start_x, int start_y, int start_dir, int user0,
                                    int user1, int user2, int user3, void* stream) {
  if (V != MINIGRID_VIEW || W < 1 || H < 1 || M < 0 || T < 0 || N < 0 || K < 0 || P < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const ExtParams p{max_steps, n_obstacles, num_crossings, obstacle_cell, start_x, start_y, start_dir,
                    {user0, user1, user2, user3}};
  const CacheRows csc{c_ax, c_ay, c_dir, c_carry, c_step, c_max_steps, c_term, c_trunc};
  const Args a{actions, grid, cont, sc, mis, cgrid, ccont, csc, cmis, cscal, scal, planes, cplanes, seeds,
               used, obs, rew, done, W, H, R, M, T, N, K, P};
  const int flags[4] = {no_objects, static_mission, see_through, compute_obs};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool ok = false;
  with_ext(ext_id, [&](auto ext) {
    using Ext = decltype(ext);
    ok = ext_launch_ok<Ext>(ext_id, p, W, H, R, K, P, flags, scal, cscal, seeds, planes, cplanes);
    if (ok && N > 0) dispatch<MINIGRID_VIEW, Ext>(a, p, flags, st);
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  return N == 0 ? (int)cudaSuccess : (int)cudaGetLastError();
}
