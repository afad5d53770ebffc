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
// seed and episode ordinal (both at the pre-increment `used`): the ext's
// per-lane reset on a ResetCtx of the env's columns (grid, and the contents,
// mission and planes where the instantiation carries them).  It streams obs, direction, the
// unmapped action, logp, value, reward and done.
//
// Design.  A block owns EB = 64 envs, one wgmma M tile, and has two
// consumer warpgroups (warps 0-7) and a producer warp (warp 8).  Per step
//   1. warps 0-1, one lane per env, build the view through minigrid_env.cuh
//      (shared with fused_rollout.cu) into the block's obs tile in shared
//      memory, which the block then stores coalesced, and turn the view into
//      one-hot bits, one 32-bit word per 32 feature rows of W1
//      [V*V*20+4, HID] (a field outside its range sets no bit, as cell_rows
//      says);
//   2. layer 1 is the one-hot product on the tensor cores (hopper.cuh),
//      each warpgroup half the columns: the A fragments (bf16 0/1) come
//      straight from the bits in registers, W1's K tiles stream by TMA
//      (one-dimensional bulk copies) through a ring of STAGES stages that
//      the producer warp keeps full, across steps, and wgmma accumulates in
//      f32.  W1 comes split as hi + lo (its bits from 2^-16 up, and the
//      rest), each product with its own accumulator: both sums are exact,
//      so their f32 sum is the exact sum rounded once, as the plain
//      version's is, in any order (in one accumulator a tiny weight's low
//      bits are cut against the running sum).  Then, as the TPU kernel does
//      (actor_rollout.py:120-121), f32 b1 is added, ReLU applied and h1
//      rounded to bf16 into shared memory;
//   3. layer 2, h2 = bf16(ReLU(h1 @ W2 + b2)) with W2 [HID, HID] (flax [in,
//      out]) resident in shared memory, runs on the CUDA cores of both
//      warpgroups as f32 FMA chains over k in order, a warp 8 envs, a lane
//      HID/32 columns: the plain version's product to the bit.  On the
//      tensor cores (measured on the H100) the other summation order flips
//      the bf16 rounding of some h2 and moves logp and value by up to 1e-3,
//      past the contract's 1e-4;
//   4. heads on the tensor cores (warpgroup 0): h2 @ the NA + 1 head rows
//      (NA logits, then the value, padded to 8 rows, resident), + f32 bias,
//      into shared memory (f32 outputs: no rounding for the order to flip);
//   5. warps 0-1 sample (u = (bits[31:8] + 0.5) / 2^24, z = lg - log(-log u),
//      first maximum wins; logp = lg[a] - logsumexp(lg), with accurate
//      logf/expf), then step and reset their envs through the family's Ext
//      struct (fused_ext.cuh and ext/*.cuh, the same structs as the
//      random-policy kernel; ext_id picks the instantiation).
// The weights come in the layouts of ops/actor_rollout.tile_actor_weights,
// made once per call in Python: W1 split, in the B layout, padded to
// WORDS*32 rows, its columns in layer 1's passes; the heads in the B
// layout padded to 8 rows; W2 as it is.
// Shapes.  The kernel is a template over the view V (odd, 3 to 31) and the
// hidden width HID (a multiple of 32, 32 to 512).  The built-in library
// holds V = 7 at HID 64 and 256; any other shape is built for the family
// that launches it (ops/_build.Shape).  What a shape changes: layer 1 runs
// at N = HID/2 a warpgroup (hopper.cuh's wgmma_cols), in two passes of
// HID/4 above 256, whose accumulators would not fit the registers (W1's
// tiles stream once a pass, an earlier pass's h1 kept as bf16 pairs in
// registers until the bits are done with); W2 stays in shared memory where
// it leaves two W1 stages (Smem::W2_RESIDENT), else layer 2 reads its rows
// from device memory (L2); layer 2 takes HID/32 consecutive columns a lane
// at widths 64, 128 and 256 and columns 32 apart otherwise, in passes of 8
// above 256, whose h2 then goes beside h1; the heads take K tiles 16 at a
// time.  A view above 7 keeps no V x V cells in registers and no obs tile:
// its rows' lit masks first (view_lit), then its cells in order, each
// written straight to obs and its 20 feature bits appended to the one-hot
// words through a 64-bit buffer (31 x 31 cells make 602 words, 154 KB for
// the block's 64 envs, over the activations).
// The family's extra state (Ext::Extra, up to 19 ints for
// Dynamic-Obstacles) lives in shared memory, one slot per env: in
// registers it would be allocated to every thread.  The seeds, and a cached
// ext's scalars of the cache slot, are read from device memory at each
// reset straight into that slot.  An ext's extra planes (BabyAI's verifier:
// two planes of W*H bytes per env) stay in device memory, env-minor as the
// grid is ([P, W*H, N]).  A block whose last 32 envs lie past N (N a
// multiple of 32, not of 64) runs them as rows of zeros and writes nothing
// of them.
//
// What bounds it on this card.  W1 is read once per block-step instead of
// once per env-step: 128 blocks x 2 x 496 KB (hi and lo) per step at 8192
// envs, from L2, against the one-hot product's 2 x 992 x HID multiply-adds
// per env on the tensor cores.  Layer 2's HID x HID FMAs per env on the
// CUDA cores (16K a thread a step at HID = 256, 8 warps) are the larger
// share: the price of matching the plain version's rounding.  The env phase
// runs on two warps while the others wait, and a counter reset
// (Dynamic-Obstacles scans the grid twice per ball) holds the block.
// Next: layer 2 on the tensor cores with the CUDA cores recomputing only
// the outputs that land near a bf16 rounding boundary; a 2-CTA cluster
// sharing W1's tiles by TMA multicast; the env phase overlapping the MLP
// of the other half of the block (ping-pong).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "exts.cuh"
#include "hopper.cuh"
#include "minigrid_env.cuh"

namespace {

using namespace minigrid;
using namespace hopper;

constexpr int EB = 64;                 // envs per block: one wgmma M tile
constexpr int MMA_WARPS = 4;           // warpgroup 0: the heads; its first EB threads run the envs
constexpr int CONSUMERS = 256;         // warpgroups 0 and 1: layer 1 (half the columns each) and layer 2
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int MAX_HEADS = 8;           // NA logits + 1 value, NA <= 7: the heads' N
constexpr int SMEM_LIMIT = 232448;     // dynamic shared memory a block may opt into

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
  const __nv_bfloat16* w1;   // W1 [WORDS*32, HID] as hi and lo, per K tile, in the B layout
  const float* b1;           // [HID]
  const __nv_bfloat16* w2;   // W2 [HID, HID] in the tiled B layout
  const float* b2;           // [HID]
  const __nv_bfloat16* wh;   // the head rows as B [HID, 8] (logits, value, 0), tiled
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

// One-hot words per env: W1's rows padded to a multiple of 32.
constexpr int words_for(int V) { return (V * V * FEATURES_PER_CELL + 4 + 31) / 32; }

// The dynamic shared memory of one instantiation, in bytes from the base.
template <int V, int HID, class Ext>
struct Smem {
  static constexpr int WORDS = words_for(V);
  // Layer 1 runs in passes of at most 128 columns a warpgroup, whose hi and
  // lo accumulators fit the registers: two above HID = 256.
  static constexpr int PASSES = HID > 256 ? 2 : 1;
  static constexpr int NP = HID / 2 / PASSES;           // a warpgroup's columns a pass
  static constexpr int STAGE = 2 * (HID / PASSES) * 32;  // a K tile of W1's pass columns: its hi and lo parts
  static constexpr int HW = HID / 2 + 1;                 // 32-bit words per activation row (odd: no bank conflicts)
  // Layer 2 runs in passes of at most 8 columns a lane: two above HID =
  // 256, and then h2 goes beside h1 instead of over it.
  static constexpr int L2_PASSES = (HID / 32 + 7) / 8;
  static constexpr int ACTS = L2_PASSES > 1 ? 2 : 1;
  // A view up to 7 keeps its obs tile beside the one-hot bits; a wider one
  // writes its obs straight out.
  static constexpr bool WIDE = V > 7;
  static constexpr int ENV_BYTES = EB * (WORDS + (WIDE ? 0 : V * V)) * 4;
  // The activations [ACTS][EB][HW] (bf16 pairs); before layer 1's end the
  // same space holds the one-hot bits [EB][WORDS] and the obs tile [EB][V*V].
  static constexpr int ACT_BYTES = ACTS * EB * HW * 4 > ENV_BYTES ? ACTS * EB * HW * 4 : ENV_BYTES;
  static constexpr int W2_BYTES = HID * HID * 2;
  // W2 stays in shared memory where it leaves room for two W1 stages; a
  // wider or a wide view's reads its rows from device memory (through L2).
  static constexpr bool W2_RESIDENT =
      (SMEM_LIMIT - W2_BYTES - HID * MAX_HEADS * 2 - ACT_BYTES - 2 * HID * 4 - EB * MAX_HEADS * 4 -
       EB * (int)sizeof(typename Ext::Extra) - 16 - 16 * 17) / STAGE >= 2;
  static constexpr int W2 = 0;  // [HID][HID] bf16, row-major
  static constexpr int WH = W2 + (W2_RESIDENT ? W2_BYTES : 0);
  static constexpr int RING = WH + HID * MAX_HEADS * 2;
  static constexpr int FIXED = RING + ACT_BYTES + 2 * HID * 4 + EB * MAX_HEADS * 4 +
                               EB * (int)sizeof(typename Ext::Extra) + 16;
  // As many stages as fit, at most 8.
  static constexpr int FIT = (SMEM_LIMIT - FIXED - 16 * 17) / STAGE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int ACT = RING + STAGES * STAGE;
  static constexpr int B1 = ACT + ACT_BYTES;
  static constexpr int B2 = B1 + HID * 4;
  static constexpr int HEAD = B2 + HID * 4;
  static constexpr int X = HEAD + EB * MAX_HEADS * 4;
  static constexpr int BARS = (X + EB * (int)sizeof(typename Ext::Extra) + 15) / 16 * 16;
  static constexpr int BYTES = BARS + (2 * STAGES + 1) * 8;
  static_assert(STAGES >= 2, "the W1 ring needs two stages");
  static_assert(BYTES <= SMEM_LIMIT, "shared memory");
  static_assert(HID % 32 == 0 && HID >= 32 && HID <= 512, "a hidden width that is a multiple of 32 up to 512");
  static_assert(V % 2 == 1 && V >= 3 && V <= 31, "an odd view from 3 to 31");
};

// The env's one-hot words from its view and direction: word w holds
// feature rows 32w..32w+31, from the cells (and the direction, after the V2
// cells) whose 20 rows overlap it.
template <int V, int WORDS>
__device__ __forceinline__ void onehot_words(const int (&view)[V][V], int d, uint32_t* out) {
  constexpr int V2 = V * V, F = FEATURES_PER_CELL;
  uint32_t cb[V2 + 1];
#pragma unroll
  for (int s = 0; s < V2; ++s) cb[s] = cell_bits(view[s / V][s % V]);
  cb[V2] = d >= 0 && d < 4 ? 1u << d : 0u;
#pragma unroll
  for (int w = 0; w < WORDS; ++w) {
    uint32_t word = 0;
#pragma unroll
    for (int s = (32 * w) / F; s <= V2 && s <= (32 * w + 31) / F; ++s) {
      const int shift = F * s - 32 * w;
      word |= shift >= 0 ? cb[s] << shift : cb[s] >> -shift;
    }
    out[w] = word;
  }
}

// Layer 2's share of a consumer thread of W2's row where HID/32 is 2, 4
// or 8: HID/32 consecutive columns (8 at HID = 256: one 16-byte load; a
// warp reads the whole row, conflict-free).  Other widths take columns
// 32 apart (w2_at).
template <int HID>
__device__ __forceinline__ void w2_row(const __nv_bfloat16* row, int cg, float (&w)[HID / 32]) {
  if constexpr (HID == 256) {
    const uint4 v = *reinterpret_cast<const uint4*>(row + 8 * cg);
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      w[2 * q] = __uint_as_float(u[q] << 16);
      w[2 * q + 1] = __uint_as_float(u[q] & 0xFFFF0000u);
    }
  } else if constexpr (HID == 128) {
    const uint2 v = *reinterpret_cast<const uint2*>(row + 4 * cg);
    w[0] = __uint_as_float(v.x << 16);
    w[1] = __uint_as_float(v.x & 0xFFFF0000u);
    w[2] = __uint_as_float(v.y << 16);
    w[3] = __uint_as_float(v.y & 0xFFFF0000u);
  } else {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(row + 2 * cg);
    w[0] = __uint_as_float(v << 16);
    w[1] = __uint_as_float(v & 0xFFFF0000u);
  }
}

// W2's element `idx` as a float: from shared memory where W2 is resident,
// else from device memory through the read-only path.
template <bool RESIDENT>
__device__ __forceinline__ float w2_at(const __nv_bfloat16* w2, int idx) {
  const unsigned short* u = reinterpret_cast<const unsigned short*>(w2);
  return __uint_as_float((uint32_t)(RESIDENT ? u[idx] : __ldg(u + idx)) << 16);
}

template <int V, int HID, class Ext, bool NO_OBJECTS, bool STATIC_MISSION, bool SEE_THROUGH>
__global__ void __launch_bounds__(THREADS, 1) actor_kernel(const Args a, const ExtParams p) {
  using L = Smem<V, HID, Ext>;
  constexpr int V2 = V * V;
  constexpr int WORDS = L::WORDS;
  constexpr int STAGES = L::STAGES;
  constexpr int HW = L::HW;
  constexpr int PASSES = L::PASSES;
  constexpr int NP = L::NP;
  constexpr int KT2 = HID / 16;  // K tiles of the heads
  constexpr int CPT = HID / 32;  // layer 2: columns per thread (8 envs each)
  extern __shared__ __align__(128) unsigned char smem[];
  // W2 in shared memory, or where the caller's tensor lies.
  const __nv_bfloat16* w2_s = L::W2_RESIDENT ? reinterpret_cast<const __nv_bfloat16*>(smem + L::W2) : a.w2;
  const __nv_bfloat16* wh_s = reinterpret_cast<const __nv_bfloat16*>(smem + L::WH);
  unsigned char* ring = smem + L::RING;
  uint32_t* act_s = reinterpret_cast<uint32_t*>(smem + L::ACT);  // [EB][HW] bf16 pairs: h1
  uint32_t* h2_s = act_s + (L::ACTS - 1) * EB * HW;              // h2: over h1, or beside it
  uint32_t* bits_s = act_s;                                         // [EB][WORDS], before layer 1's end
  int* obs_s = reinterpret_cast<int*>(act_s + EB * WORDS);          // [EB][V2], likewise (views up to 7)
  float* b1_s = reinterpret_cast<float*>(smem + L::B1);
  float* b2_s = reinterpret_cast<float*>(smem + L::B2);
  float* head_s = reinterpret_cast<float*>(smem + L::HEAD);         // [EB][MAX_HEADS]
  typename Ext::Extra* x_s = reinterpret_cast<typename Ext::Extra*>(smem + L::X);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* resident = empty + STAGES;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t N = (size_t)a.N;
  const int n0 = blockIdx.x * EB;
  const int valid = min(EB, a.N - n0);

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMERS / 32);
    }
    mbar_init(resident, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // The producer: W2 and the heads once, then W1's K tiles (hi and lo),
    // a tile a stage, for every step, as fast as the ring frees.
    if (lane == 0) {
      constexpr uint32_t W2_BYTES = L::W2_RESIDENT ? HID * HID * 2 : 0, WH_BYTES = HID * MAX_HEADS * 2;
      mbar_arrive_expect_tx(resident, W2_BYTES + WH_BYTES);
      if constexpr (L::W2_RESIDENT) bulk_g2s(smem + L::W2, a.w2, W2_BYTES, resident);
      bulk_g2s(smem + L::WH, a.wh, WH_BYTES, resident);
      int stage = 0;
      uint32_t phase = 0;
      const unsigned char* w1 = reinterpret_cast<const unsigned char*>(a.w1);
      for (int t = 0; t < a.T; ++t) {
        for (int ps = 0; ps < PASSES; ++ps) {
          for (int kt = 0; kt < 2 * WORDS; ++kt) {
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_arrive_expect_tx(&full[stage], L::STAGE);
            bulk_g2s(ring + stage * L::STAGE, w1 + ((size_t)ps * 2 * WORDS + kt) * L::STAGE, L::STAGE, &full[stage]);
            if (++stage == STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
    return;
  }

  // The consumers.  Rows of the MMA tiles: warp w of a warpgroup holds envs
  // 16w + g and 16w + g + 8 of the block; warpgroup wg takes layer 1's
  // columns HID/2*wg.., warpgroup 0 the heads.  Layer 2: warp eg takes envs
  // 8eg.., lane cg columns CPT*cg...
  const bool head_warp = warp < MMA_WARPS;
  const int wg = warp / MMA_WARPS;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int r0 = 16 * (warp % MMA_WARPS) + g;
  const int eg = warp;
  const int cg = lane;
  const bool env_thread = tid < valid;  // thread e runs env n0 + e
  const int n = n0 + tid;
  const int WH = a.W * a.H;
  const int na = a.NA;
  const Cache cache{a.cgrid, a.ccont, a.csc, a.cmis, a.cscal, a.cplanes, a.R, a.K, a.P};
  int* grid = a.grid + n;
  int* cont = a.cont + n;
  int* mis = a.mis + n;
  uint8_t* planes = Ext::NUM_PLANES > 0 ? a.planes + n : nullptr;

  for (int i = tid; i < HID; i += CONSUMERS) {
    b1_s[i] = a.b1[i];
    b2_s[i] = a.b2[i];
  }
  Scalars s{};
  int used = 0;
  if (env_thread) {
    s = load_scalars(a.sc + n, N);
    x_s[tid] = Ext::load(a.scal, n, N, p);
  }
  mbar_wait(resident, 0);

  int stage = 0;
  uint32_t phase = 0;
  for (int t = 0; t < a.T; ++t) {
    const size_t tn = (size_t)t * N;

    // 1. Observe the current state: the obs tile (stored coalesced below)
    // and the direction out, the one-hot words in.  A row past N is all
    // zero bits.
    if (tid < EB) {
      if (env_thread) {
        if constexpr (!L::WIDE) {
          int view[V][V];
          view_cells<V>(grid, N, a.W, a.H, s, view);
          hide_unseen<V, SEE_THROUGH>(view);
#pragma unroll
          for (int i = 0; i < V; ++i)
#pragma unroll
            for (int j = 0; j < V; ++j) obs_s[tid * V2 + i * V + j] = view[i][j];
          a.dir[tn + n] = s.d;
          onehot_words<V, WORDS>(view, s.d, bits_s + tid * WORDS);
        } else {
          // A wider view: its rows' lit masks, then its cells in order,
          // each written out and its 20 feature bits appended to the
          // words (a 64-bit buffer of the bits not yet written).
          const ViewFrame f = view_frame(s.ax, s.ay, s.d);
          uint32_t lit[V];
          view_lit<V, SEE_THROUGH>(grid, N, a.W, a.H, f, s.carry, lit);
          int* orow = a.obs + (tn + n) * V2;
          uint32_t* brow = bits_s + tid * WORDS;
          uint64_t pend = 0;
          int held = 0, w = 0;
#pragma unroll 1
          for (int i = 0; i < V; ++i) {
#pragma unroll
            for (int j = 0; j < V; ++j) {
              const int v = (lit[j] >> i) & 1u ? view_value<V>(grid, N, a.W, a.H, f, s.carry, i, j) : 0;
              orow[i * V + j] = v;
              pend |= (uint64_t)cell_bits(v) << held;
              held += FEATURES_PER_CELL;
              if (held >= 32) {
                brow[w++] = (uint32_t)pend;
                pend >>= 32;
                held -= 32;
              }
            }
          }
          pend |= (uint64_t)(s.d >= 0 && s.d < 4 ? 1u << s.d : 0u) << held;
          for (; w < WORDS; ++w) {
            brow[w] = (uint32_t)pend;
            pend >>= 32;
          }
          a.dir[tn + n] = s.d;
        }
      } else {
        for (int w = 0; w < WORDS; ++w) bits_s[tid * WORDS + w] = 0;
      }
    }
    named_sync(1, CONSUMERS);
    if constexpr (!L::WIDE) {
      int* obs_dst = a.obs + (tn + n0) * V2;
      for (int k = tid; k < valid * V2; k += CONSUMERS) obs_dst[k] = obs_s[k];
    }

    // 2. Layer 1: one-hot @ W1 on the tensor cores, a K tile per ring stage,
    // each warpgroup half the columns (in two passes above HID = 256, a
    // pass's W1 tiles streamed anew).  W1 comes split as hi + lo (its bits
    // from 2^-16 up, and the rest), so that each sum is exact in the f32
    // accumulators and their f32 sum is the exact sum rounded once, whatever
    // the order (a tiny weight's low bits would otherwise be truncated against
    // a large running sum).  The A fragments of consecutive tiles alternate
    // between two register sets, so a tile's fragments are built while the
    // previous tile's wgmmas run.
    {
      // An earlier pass's h1, as bf16 pairs, until the bits are done with.
      uint32_t h1p[PASSES > 1 ? PASSES - 1 : 1][NP / 4];
#pragma unroll
      for (int ps = 0; ps < PASSES; ++ps) {
        float acc[NP / 2], acc_lo[NP / 2];
#pragma unroll
        for (int i = 0; i < NP / 2; ++i) acc[i] = acc_lo[i] = 0.f;
        uint32_t frag[2][4];
        int prev_stage = 0;
        auto layer1_tile = [&](int kt, uint32_t(&cur)[4], uint32_t(&prev)[4]) {
          const int shift = 16 * (kt & 1) + 2 * c;
          const uint32_t w0 = bits_s[r0 * WORDS + kt / 2] >> shift;
          const uint32_t w1 = bits_s[(r0 + 8) * WORDS + kt / 2] >> shift;
          cur[0] = onehot_pair(w0);
          cur[1] = onehot_pair(w1);
          cur[2] = onehot_pair(w0 >> 8);
          cur[3] = onehot_pair(w1 >> 8);
          mbar_wait(&full[stage], phase);
          const unsigned char* tile = ring + stage * L::STAGE + wg * NP * 32;  // this half's n groups
          wgmma_fence();
          wgmma_cols<NP>(acc, cur, b_desc(tile));
          wgmma_cols<NP>(acc_lo, cur, b_desc(tile + 2 * NP * 32));
          wgmma_commit();
          // The previous tile's wgmmas are done: its stage and registers free.
          wgmma_wait<1>();
#pragma unroll
          for (int i = 0; i < 4; ++i) fence_operand(prev[i]);
          if (kt > 0 && lane == 0) mbar_arrive(&empty[prev_stage]);
          prev_stage = stage;
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        };
        for (int kt = 0; kt < 2 * WORDS; kt += 2) {
          layer1_tile(kt, frag[0], frag[1]);
          layer1_tile(kt + 1, frag[1], frag[0]);
        }
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < NP / 2; ++i) {
          fence_operand(acc[i]);
          fence_operand(acc_lo[i]);
          acc[i] += acc_lo[i];
        }
        if (lane == 0) mbar_arrive(&empty[prev_stage]);
        if (ps + 1 < PASSES) {
          // h1 = bf16(ReLU(acc + b1)), kept until the last pass.
#pragma unroll
          for (int j = 0; j < NP / 8; ++j) {
            const int col = HID / 2 * wg + ps * NP + 8 * j + 2 * c;
            const float2 b = *reinterpret_cast<const float2*>(b1_s + col);
            h1p[ps][2 * j] = pack_bf16(fmaxf(acc[4 * j] + b.x, 0.f), fmaxf(acc[4 * j + 1] + b.y, 0.f));
            h1p[ps][2 * j + 1] = pack_bf16(fmaxf(acc[4 * j + 2] + b.x, 0.f), fmaxf(acc[4 * j + 3] + b.y, 0.f));
          }
          continue;
        }
        named_sync(1, CONSUMERS);  // every thread is done with the bits

        // h1 = bf16(ReLU(acc + b1)) into the activation rows, the earlier
        // passes' columns first.
#pragma unroll
        for (int pp = 0; pp < ps; ++pp)
#pragma unroll
          for (int j = 0; j < NP / 8; ++j) {
            const int col = HID / 2 * wg + pp * NP + 8 * j + 2 * c;
            act_s[r0 * HW + col / 2] = h1p[pp][2 * j];
            act_s[(r0 + 8) * HW + col / 2] = h1p[pp][2 * j + 1];
          }
#pragma unroll
        for (int j = 0; j < NP / 8; ++j) {
          const int col = HID / 2 * wg + ps * NP + 8 * j + 2 * c;
          const float2 b = *reinterpret_cast<const float2*>(b1_s + col);
          act_s[r0 * HW + col / 2] = pack_bf16(fmaxf(acc[4 * j] + b.x, 0.f), fmaxf(acc[4 * j + 1] + b.y, 0.f));
          act_s[(r0 + 8) * HW + col / 2] =
              pack_bf16(fmaxf(acc[4 * j + 2] + b.x, 0.f), fmaxf(acc[4 * j + 3] + b.y, 0.f));
        }
      }
    }
    named_sync(1, CONSUMERS);

    // 3. Layer 2 on the CUDA cores: each output an f32 FMA chain over k in
    // order, the plain version's product (a tensor-core sum, in another
    // order, flips the bf16 rounding of h2 often enough to move the value
    // past PLAIN_ATOL); then + b2, ReLU, bf16.
    if constexpr (CPT == 2 || CPT == 4 || CPT == 8) {
      float acc2[8 * CPT];
#pragma unroll
      for (int i = 0; i < 8 * CPT; ++i) acc2[i] = 0.f;
#pragma unroll 2
      for (int k = 0; k < HID; k += 2) {
        float x0[8], x1[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const uint32_t v = act_s[(8 * eg + e) * HW + k / 2];
          x0[e] = __uint_as_float(v << 16);
          x1[e] = __uint_as_float(v & 0xFFFF0000u);
        }
        float w0[CPT], w1[CPT];
        w2_row<HID>(w2_s + (size_t)k * HID, cg, w0);
        w2_row<HID>(w2_s + (size_t)(k + 1) * HID, cg, w1);
#pragma unroll
        for (int e = 0; e < 8; ++e)
#pragma unroll
          for (int q = 0; q < CPT; ++q) acc2[e * CPT + q] = fmaf(x0[e], w0[q], acc2[e * CPT + q]);
#pragma unroll
        for (int e = 0; e < 8; ++e)
#pragma unroll
          for (int q = 0; q < CPT; ++q) acc2[e * CPT + q] = fmaf(x1[e], w1[q], acc2[e * CPT + q]);
      }
      named_sync(1, CONSUMERS);  // every thread is done with h1
#pragma unroll
      for (int e = 0; e < 8; ++e)
#pragma unroll
        for (int q = 0; q < CPT; q += 2) {
          const int col = CPT * cg + q;
          act_s[(8 * eg + e) * HW + col / 2] = pack_bf16(fmaxf(acc2[e * CPT + q] + b2_s[col], 0.f),
                                                       fmaxf(acc2[e * CPT + q + 1] + b2_s[col + 1], 0.f));
        }
    } else {
      // Other widths: lane cg takes columns cg + 32 q, QP of them a pass
      // (two passes above HID = 256, whose h2 goes beside h1).
      constexpr int QP = CPT < 8 ? CPT : 8;
      __nv_bfloat16* h2b = reinterpret_cast<__nv_bfloat16*>(h2_s);
#pragma unroll
      for (int q0 = 0; q0 < CPT; q0 += QP) {
        float acc2[8 * QP];
#pragma unroll
        for (int i = 0; i < 8 * QP; ++i) acc2[i] = 0.f;
#pragma unroll 2
        for (int k = 0; k < HID; k += 2) {
          float x0[8], x1[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const uint32_t v = act_s[(8 * eg + e) * HW + k / 2];
            x0[e] = __uint_as_float(v << 16);
            x1[e] = __uint_as_float(v & 0xFFFF0000u);
          }
          float w0[QP], w1[QP];
#pragma unroll
          for (int q = 0; q < QP; ++q) {
            const int col = cg + 32 * (q0 + q);
            w0[q] = q0 + q < CPT ? w2_at<L::W2_RESIDENT>(w2_s, k * HID + col) : 0.f;
            w1[q] = q0 + q < CPT ? w2_at<L::W2_RESIDENT>(w2_s, (k + 1) * HID + col) : 0.f;
          }
#pragma unroll
          for (int e = 0; e < 8; ++e)
#pragma unroll
            for (int q = 0; q < QP; ++q) acc2[e * QP + q] = fmaf(x0[e], w0[q], acc2[e * QP + q]);
#pragma unroll
          for (int e = 0; e < 8; ++e)
#pragma unroll
            for (int q = 0; q < QP; ++q) acc2[e * QP + q] = fmaf(x1[e], w1[q], acc2[e * QP + q]);
        }
        if constexpr (L::ACTS == 1) named_sync(1, CONSUMERS);  // every thread is done with h1, which h2 overwrites
#pragma unroll
        for (int e = 0; e < 8; ++e)
#pragma unroll
          for (int q = 0; q < QP; ++q) {
            const int col = cg + 32 * (q0 + q);
            if (q0 + q < CPT) {
              h2b[(8 * eg + e) * 2 * HW + col] = __float2bfloat16_rn(fmaxf(acc2[e * QP + q] + b2_s[col], 0.f));
            }
          }
      }
    }
    named_sync(1, CONSUMERS);

    // 4. Heads on the tensor cores: h2 @ the head rows, + f32 bias, in
    // groups of up to 16 K tiles (their A fragments in registers).
    if (head_warp) {
      constexpr int KG = KT2 < 16 ? KT2 : 16;
      float hd[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k0 = 0; k0 < KT2; k0 += KG) {
        uint32_t h[KG][4];
#pragma unroll
        for (int kk = 0; kk < KG; ++kk) {
          h[kk][0] = h2_s[r0 * HW + 8 * (k0 + kk) + c];
          h[kk][1] = h2_s[(r0 + 8) * HW + 8 * (k0 + kk) + c];
          h[kk][2] = h2_s[r0 * HW + 8 * (k0 + kk) + 4 + c];
          h[kk][3] = h2_s[(r0 + 8) * HW + 8 * (k0 + kk) + 4 + c];
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KG; ++kk) wgmma_m64n8k16_rs(hd, h[kk], b_desc(wh_s + (k0 + kk) * MAX_HEADS * 16));
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 4; ++i) fence_operand(hd[i]);
#pragma unroll
        for (int kk = 0; kk < KG; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) fence_operand(h[kk][i]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int col = 2 * c + u;
        if (col <= na) {
          head_s[r0 * MAX_HEADS + col] = hd[u] + a.bh[col];
          head_s[(r0 + 8) * MAX_HEADS + col] = hd[2 + u] + a.bh[col];
        }
      }
    }
    named_sync(1, CONSUMERS);

    // 5. Sample, then step and auto-reset.
    if (env_thread) {
      float lg[MAX_HEADS - 1];
#pragma unroll
      for (int k = 0; k < MAX_HEADS - 1; ++k) lg[k] = k < na ? head_s[tid * MAX_HEADS + k] : 0.f;
      const float value = head_s[tid * MAX_HEADS + na];
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

      typename Ext::Extra& x = x_s[tid];
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
          // The env's column (stride N), contents, mission and planes where
          // the instantiation carries them.
          const ResetCtx rc{grid, NO_OBJECTS ? nullptr : cont, STATIC_MISSION ? nullptr : mis, planes, N,
                            a.W, a.H, a.M};
          const Words e = episode_seed((uint32_t)a.seeds[n], (uint32_t)a.seeds[N + n], used);
          Ext::reset(p, e, rc, s, x);
        } else {
          cache_reset<Ext, NO_OBJECTS, STATIC_MISSION>(cache, p, n, used, grid, cont, mis, planes, N, WH, a.M, s, x);
        }
        used += 1;
      }
    }
  }
  if (env_thread) {
    store_scalars(a.sc + n, N, s);
    Ext::store(a.scal, n, N, p, x_s[tid]);
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
    auto kernel = actor_kernel<V, HID, Ext, Fixed...>;
    constexpr int bytes = Smem<V, HID, Ext>::BYTES;
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes) != cudaSuccess) return;
    kernel<<<(a.N + EB - 1) / EB, THREADS, bytes, stream>>>(a, p);
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

// The shapes (view, hidden width) this library holds: the built-in one view
// 7 at the PPO configuration's 256 and the tests' narrow 64; a library
// built for one family's shape (ops/_build.Shape: -DMINIGRID_VIEW,
// -DMINIGRID_HIDDEN, and -DMINIGRID_ONLY_EXT for a built-in ext) that one.
#ifdef MINIGRID_VIEW
#define ACTOR_SHAPES(X) X(MINIGRID_VIEW, MINIGRID_HIDDEN)
#else
#define ACTOR_SHAPES(X) X(7, 256) X(7, 64)
#endif

// Whether the library holds view V at this hidden width.
extern "C" int actor_rollout_supports(int V, int hidden) {
#define ACTOR_HOLDS(v, h) \
  if (V == (v) && hidden == (h)) return 1;
  ACTOR_SHAPES(ACTOR_HOLDS)
#undef ACTOR_HOLDS
  return 0;
}

// One-hot words per env at view size V: W1 comes padded to 32 rows per word.
extern "C" int actor_rollout_words(int V) { return words_for(V); }

// Dynamic shared memory (bytes), W1 ring stages and whether W2 stays in
// shared memory (1) or is read from device memory (0), of the
// instantiations of `ext_id` at view V and width `hidden`, for reports;
// -1 for an unknown id or shape.
extern "C" int actor_rollout_smem_bytes(int V, int hidden, int ext_id) {
  int bytes = -1;
  with_ext(ext_id, [&](auto ext) {
    using Ext = decltype(ext);
#define ACTOR_BYTES(v, h) \
  if (V == (v) && hidden == (h)) bytes = Smem<(v), (h), Ext>::BYTES;
    ACTOR_SHAPES(ACTOR_BYTES)
#undef ACTOR_BYTES
  });
  return bytes;
}

extern "C" int actor_rollout_stages(int V, int hidden, int ext_id) {
  int stages = -1;
  with_ext(ext_id, [&](auto ext) {
    using Ext = decltype(ext);
#define ACTOR_STAGES(v, h) \
  if (V == (v) && hidden == (h)) stages = Smem<(v), (h), Ext>::STAGES;
    ACTOR_SHAPES(ACTOR_STAGES)
#undef ACTOR_STAGES
  });
  return stages;
}

extern "C" int actor_rollout_w2_resident(int V, int hidden, int ext_id) {
  int resident = -1;
  with_ext(ext_id, [&](auto ext) {
    using Ext = decltype(ext);
#define ACTOR_W2(v, h) \
  if (V == (v) && hidden == (h)) resident = Smem<(v), (h), Ext>::W2_RESIDENT;
    ACTOR_SHAPES(ACTOR_W2)
#undef ACTOR_W2
  });
  return resident;
}

// Launches the collection on `stream`; returns a cudaError_t (0 on success).
// ext_id 0 (NoExt) takes the reset cache (R >= 1; scal, cscal, planes,
// cplanes and seeds unused); a cached ext takes the cache with its K extra
// scalars (cscal) and P extra planes (cplanes) and its live ones (scal,
// planes); a counter-reset ext takes seeds and K extra scalars (R = 0, no
// cache), and writes its P planes at each reset.  user0..3 are a user
// family's ExtParams::user slots.  w1, w2 and wh are in the tiled layout of
// hopper.cuh.
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
                                    int start_dir, int user0, int user1, int user2, int user3,
                                    void* stream) {
  if (!actor_rollout_supports(V, hidden) || W < 1 || H < 1 || M < 0 || T < 0 || N < 0 || N % 32 != 0 || K < 0 ||
      P < 0 || NA < 1 || NA > MAX_HEADS - 1) {
    return (int)cudaErrorInvalidValue;
  }
  const ExtParams p{max_steps, n_obstacles, num_crossings, obstacle_cell, start_x, start_y, start_dir,
                    {user0, user1, user2, user3}};
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
#define ACTOR_LAUNCH(v, h) \
  if (V == (v) && hidden == (h)) dispatch<(v), (h), Ext>(a, p, flags, s);
    ACTOR_SHAPES(ACTOR_LAUNCH)
#undef ACTOR_LAUNCH
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  return N == 0 ? (int)cudaSuccess : (int)cudaGetLastError();
}
