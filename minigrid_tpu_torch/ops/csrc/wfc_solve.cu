// The batched Wave Function Collapse solver for Hopper (sm_90a).
//
// Device twin of the plain solver of minigrid_tpu_torch/envs/wfc/solver.py
// (whose JAX counterpart, minigrid_tpu/envs/wfc/solver.py::wfc_solve, is a
// jitted while_loop that XLA runs as (P, P) @ (P, W*H) dots, no Pallas
// kernel): for each of N waves, attempts of collapse steps until one
// solves or max_attempts + 1 have failed; each step picks a cell (location
// heuristic), a pattern for it (pattern heuristic), collapses the cell,
// propagates the support constraints to their fixed point and, with
// backtracking, bans a choice that contradicted.  Every random draw is
// threefry2x32(seed of the wave, counter) (prng.cuh), as in the plain
// version, so the two give the same grids, outcomes and counters.
//
// One thread block (THREADS threads) owns one wave.  The wave lives in
// shared memory as P-bit masks, NW 64-bit words a cell, cell c = x * H + y;
// the threads take the cells c = tid, tid + THREADS, ...  Propagation
// sweeps the cells in place (a thread may read a neighbour's mask from
// this sweep or the last) and checks only the cells next to a change: the
// collapsed cell and its neighbours, then the neighbours of every cell
// that lost a pattern.  Each sweep only removes patterns that lack support
// in a superset of the current wave, and the loop stops after a sweep that
// changed nothing, so it reaches the same fixed point as the plain
// version's sweeps of the whole wave at once (the arc-consistency closure
// is unique), with far fewer cell checks.  A pattern p of a cell keeps
// support in direction d where the neighbour's mask meets compat[d][p]
// (the patterns that may sit there); at a non-periodic border the
// neighbour holds every pattern.  Block-wide decisions (fixed point,
// contradiction, solved, the location's arg-min with the first index on
// ties) are barrier reductions; the pattern draw is thread 0's, one pass
// over the P patterns in float64 as the plain version's cumulative sum
// (exact on the presets' integer weights).
//
// What bounds it on this card: the serial chain of each wave.  A 23x23
// MazeSimple wave takes about 300 collapse steps of a few sweeps each, each
// step a pass over the cells for the location, and every sweep and
// reduction is a block barrier; the bytes it must move
// (the tables in, the grid and counters out) are far below the card's
// memory rate and its integer work below the CUDA cores' rate.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "prng.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_WORDS = 4;  // up to 256 patterns
// Counter words of the draws: (attempt, step) for a pattern choice,
// (attempt, PREF_COUNTER | cell) for a cell's preference.
constexpr uint32_t PREF_COUNTER = 0x40000000u;

enum Loc { kEntropy = 0, kAntiEntropy, kRandom, kSimple, kLexical, kSpiral, kHilbert };
enum Choice { kWeighted = 0, kChoiceRandom, kChoiceLexical, kRarest, kMostCommon };

__constant__ int kDX[4] = {0, 1, 0, -1};
__constant__ int kDY[4] = {-1, 0, 1, 0};

struct Params {
  const int32_t* seeds;     // [N, 2]
  const uint64_t* compat;   // [4, P, NW]
  const float* weights;     // [P]
  const float* order;       // [W*H] static cell order, or nullptr
  int32_t* grid;            // [N, W*H]
  int32_t* ok;              // [N]
  int32_t* stats;           // [4, N]: attempts, collapses, backtracks, contradictions
  int N, P, W, H, periodic, max_attempts, loc, choice, backtracking;
};

struct Best {
  float s;
  int i;
};

__device__ __forceinline__ Best better(Best a, Best b) {
  return (b.s < a.s || (b.s == a.s && b.i < a.i)) ? b : a;
}

__device__ __forceinline__ double uniform53(minigrid::Words w) {
  const uint64_t bits = ((uint64_t)(w.w0 >> 5) << 26) | (uint64_t)(w.w1 >> 6);
  return (double)bits * (1.0 / 9007199254740992.0);
}

__device__ __forceinline__ bool has(const uint64_t* m, int p) {
  return (m[p >> 6] >> (p & 63)) & 1ull;
}

// Neighbour cell of c in direction d, or -1 past a non-periodic border.
__device__ __forceinline__ int neighbour(int c, int d, int W, int H, bool periodic) {
  int x = c / H + kDX[d], y = c % H + kDY[d];
  if (periodic) {
    x = (x + W) % W;
    y = (y + H) % H;
  } else if (x < 0 || x >= W || y < 0 || y >= H) {
    return -1;
  }
  return x * H + y;
}

// Marks cell c and its neighbours for the next propagation (dirty[c] = 1).
__device__ __forceinline__ void mark_around(uint8_t* dirty, int c, int W, int H, bool periodic) {
  dirty[c] = 1;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int nb = neighbour(c, d, W, H, periodic);
    if (nb >= 0) dirty[nb] = 1;
  }
}

// The wave's fixed point, in place, from a wave at its fixed point but for
// the cells marked in dirty[0, cells) (every cell, at an attempt's start);
// returns whether a cell is left empty.  A sweep checks only the marked
// cells; a cell that changes marks its neighbours for the next sweep, in
// the other half of `dirty`, which a barrier makes visible.  Both halves
// are clear on return.
template <int NW>
__device__ bool propagate(uint64_t* wave, const uint64_t* compat, uint8_t* dirty, int P, int W, int H,
                          bool periodic) {
  const int cells = W * H;
  uint8_t* cur = dirty;
  uint8_t* next = dirty + cells;
  while (true) {
    int changed = 0;
    for (int c = threadIdx.x; c < cells; c += THREADS) {
      if (!cur[c]) continue;
      cur[c] = 0;
      uint64_t* m = wave + c * NW;
      int nb[4];
#pragma unroll
      for (int d = 0; d < 4; ++d) nb[d] = neighbour(c, d, W, H, periodic);
      bool moved = false;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const uint64_t bits0 = m[w];
        uint64_t bits = bits0, keep = bits0;
        while (bits) {
          const int b = __ffsll((long long)bits) - 1;
          bits &= bits - 1;
          const int p = w * 64 + b;
          bool supported = true;
#pragma unroll
          for (int d = 0; d < 4; ++d) {
            const uint64_t* cm = compat + (d * P + p) * NW;
            bool s = false;
            if (nb[d] < 0) {
#pragma unroll
              for (int v = 0; v < NW; ++v) s |= cm[v] != 0;
            } else {
              const uint64_t* nm = wave + nb[d] * NW;
#pragma unroll
              for (int v = 0; v < NW; ++v) s |= (cm[v] & nm[v]) != 0;
            }
            supported &= s;
          }
          if (!supported) keep &= ~(1ull << b);
        }
        if (keep != bits0) {
          m[w] = keep;
          moved = true;
        }
      }
      if (moved) {
        changed = 1;
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          if (nb[d] >= 0) next[nb[d]] = 1;
        }
      }
    }
    if (!__syncthreads_or(changed)) break;
    uint8_t* t = cur;
    cur = next;
    next = t;
  }
  int empty = 0;
  for (int c = threadIdx.x; c < cells; c += THREADS) {
    uint64_t any = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) any |= wave[c * NW + w];
    empty |= any == 0;
  }
  return __syncthreads_or(empty);
}

// The cell of the next collapse: the first arg-min of the heuristic's score
// over the unresolved cells (arg-max for anti-entropy), or -1 if none; also
// whether every cell holds exactly one pattern.
template <int NW>
__device__ int choose_location(const uint64_t* wave, const float* prefs, int cells, int loc, Best* red,
                               bool* solved) {
  Best best{INFINITY, 0x7fffffff};
  int all_one = 1;
  for (int c = threadIdx.x; c < cells; c += THREADS) {
    int count = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) count += __popcll(wave[c * NW + w]);
    all_one &= count == 1;
    if (count > 1) {
      float s;
      if (loc == kEntropy || loc == kAntiEntropy) {
        s = __fadd_rn(prefs[c], (float)count);
      } else if (loc == kSimple) {
        s = (float)count;
      } else {
        s = prefs[c];
      }
      if (loc == kAntiEntropy) s = -s;
      best = better(best, Best{s, c});
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Best o{__shfl_xor_sync(0xffffffffu, best.s, off), __shfl_xor_sync(0xffffffffu, best.i, off)};
    best = better(best, o);
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = best;
  *solved = __syncthreads_and(all_one);
  Best b = red[0];
#pragma unroll
  for (int k = 1; k < WARPS; ++k) b = better(b, red[k]);
  __syncthreads();  // red is reused by the next call
  return b.i == 0x7fffffff ? -1 : b.i;
}

// Thread 0's inverse-CDF draw over the P patterns with probabilities prob(p).
template <typename Prob>
__device__ int categorical(double u, int P, Prob prob) {
  double total = 0.0;
  for (int p = 0; p < P; ++p) total += prob(p);
  const double x = u * total;
  double c = 0.0;
  int pick = -1, last = -1;
  for (int p = 0; p < P; ++p) {
    const double q = prob(p);
    c += q;
    if (q > 0.0) last = p;
    if (pick < 0 && c > x) pick = p;
  }
  if (last < 0) last = P - 1;
  return pick < 0 ? last : min(pick, last);
}

template <int NW>
__global__ void __launch_bounds__(THREADS) wfc_solve_kernel(Params prm) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = prm.P, W = prm.W, H = prm.H, cells = W * H;
  const bool periodic = prm.periodic != 0, backtracking = prm.backtracking != 0;
  uint64_t* compat = reinterpret_cast<uint64_t*>(smem);
  uint64_t* wave = compat + 4 * P * NW;
  uint64_t* snap = wave + cells * NW;
  float* prefs = reinterpret_cast<float*>(snap + (backtracking ? cells * NW : 0));
  float* weights = prefs + cells;
  int* sums = reinterpret_cast<int*>(weights + P);
  Best* red = reinterpret_cast<Best*>(sums + P);
  int* chosen = reinterpret_cast<int*>(red + WARPS);
  uint8_t* dirty = reinterpret_cast<uint8_t*>(chosen + 4);  // [2][cells]

  const int lane = blockIdx.x;
  const uint32_t k0 = (uint32_t)prm.seeds[2 * lane], k1 = (uint32_t)prm.seeds[2 * lane + 1];
  for (int i = threadIdx.x; i < 4 * P * NW; i += THREADS) compat[i] = prm.compat[i];
  for (int p = threadIdx.x; p < P; p += THREADS) weights[p] = prm.weights[p];
  for (int c = threadIdx.x; c < 2 * cells; c += THREADS) dirty[c] = 0;

  const int max_steps = 4 * cells;
  int attempts = 0, collapses = 0, backtracks = 0, contradictions = 0;
  bool ok = false;
  while (true) {
    // A fresh attempt: every pattern everywhere, this attempt's preferences.
    for (int c = threadIdx.x; c < cells; c += THREADS) {
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const int lo = w * 64, n = min(max(P - lo, 0), 64);
        wave[c * NW + w] = n == 64 ? ~0ull : ((1ull << n) - 1ull);
      }
      float pref = 0.0f;
      if (prm.loc == kLexical) {
        pref = 1.0f;
      } else if (prm.loc != kSimple) {
        const minigrid::Words r = minigrid::threefry2x32(k0, k1, (uint32_t)attempts, PREF_COUNTER | (uint32_t)c);
        pref = __fmul_rn((float)(r.w0 >> 8) * 5.9604644775390625e-8f, 0.1f);
        if ((prm.loc == kSpiral || prm.loc == kHilbert) && !(prm.order[c] > 1.5f)) pref = prm.order[c];
      }
      prefs[c] = pref;
      dirty[c] = 1;
    }
    __syncthreads();
    bool failed = propagate<NW>(wave, compat, dirty, P, W, H, periodic);
    int steps = 0;
    bool solved = false;
    while (true) {
      const int cell = choose_location<NW>(wave, prefs, cells, prm.loc, red, &solved);
      if (solved || failed || steps >= max_steps) break;
      const uint64_t* cm = wave + cell * NW;
      if (prm.choice == kRarest || prm.choice == kMostCommon) {
        for (int p = threadIdx.x; p < P; p += THREADS) sums[p] = 0;
        __syncthreads();
        for (int c = threadIdx.x; c < cells; c += THREADS) {
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            uint64_t bits = wave[c * NW + w];
            while (bits) {
              const int b = __ffsll((long long)bits) - 1;
              bits &= bits - 1;
              atomicAdd(&sums[w * 64 + b], 1);
            }
          }
        }
        __syncthreads();
      }
      if (threadIdx.x == 0) {
        const double u = uniform53(minigrid::threefry2x32(k0, k1, (uint32_t)attempts, (uint32_t)steps));
        int pattern = 0;
        switch (prm.choice) {
          case kWeighted:
            pattern = categorical(u, P, [&](int p) { return has(cm, p) ? (double)weights[p] : 0.0; });
            break;
          case kChoiceRandom:
            pattern = categorical(u, P, [&](int p) { return has(cm, p) ? 1.0 : 0.0; });
            break;
          case kChoiceLexical:
            for (pattern = 0; pattern < P && !has(cm, pattern); ++pattern) {
            }
            if (pattern == P) pattern = 0;
            break;
          default: {
            // Global possibility counts, not masked by the cell's domain; the
            // maximum for rarest, the minimum for most-common (as the JAX
            // package has them).
            int target = sums[0];
            for (int p = 1; p < P; ++p) target = prm.choice == kRarest ? max(target, sums[p]) : min(target, sums[p]);
            pattern = categorical(u, P, [&](int p) { return sums[p] == target ? 1.0 : 0.0; });
          }
        }
        chosen[0] = pattern;
      }
      if (backtracking) {
        for (int i = threadIdx.x; i < cells * NW; i += THREADS) snap[i] = wave[i];
      }
      __syncthreads();
      const int pattern = chosen[0];
      if (threadIdx.x == 0) {
#pragma unroll
        for (int w = 0; w < NW; ++w) wave[cell * NW + w] = w == (pattern >> 6) ? 1ull << (pattern & 63) : 0ull;
        mark_around(dirty, cell, W, H, periodic);
      }
      __syncthreads();
      bool contradiction = propagate<NW>(wave, compat, dirty, P, W, H, periodic);
      if (backtracking && contradiction) {
        // Pop the entry snapshot and ban the choice; the ban's own
        // contradiction fails the attempt.
        ++backtracks;
        for (int i = threadIdx.x; i < cells * NW; i += THREADS) wave[i] = snap[i];
        __syncthreads();
        if (threadIdx.x == 0) {
          wave[cell * NW + (pattern >> 6)] &= ~(1ull << (pattern & 63));
          mark_around(dirty, cell, W, H, periodic);
        }
        __syncthreads();
        contradiction = propagate<NW>(wave, compat, dirty, P, W, H, periodic);
      }
      failed = contradiction;
      ++steps;
      ++collapses;
    }
    ok = solved && !failed;
    for (int c = threadIdx.x; c < cells; c += THREADS) {
      int first = 0;
      for (int w = NW - 1; w >= 0; --w) {
        const uint64_t bits = wave[c * NW + w];
        if (bits) first = w * 64 + __ffsll((long long)bits) - 1;
      }
      prm.grid[(size_t)lane * cells + c] = first;
    }
    ++attempts;
    contradictions += !ok;
    if (ok || attempts > prm.max_attempts) break;
    __syncthreads();  // every thread has written its cells before the reset
  }
  if (threadIdx.x == 0) {
    prm.ok[lane] = ok;
    prm.stats[lane] = attempts;
    prm.stats[prm.N + lane] = collapses;
    prm.stats[2 * prm.N + lane] = backtracks;
    prm.stats[3 * prm.N + lane] = contradictions;
  }
}

size_t smem_bytes(int P, int W, int H, int NW, int backtracking) {
  const size_t cells = (size_t)W * H;
  return 8 * (4 * (size_t)P * NW + cells * NW * (backtracking ? 2 : 1)) + 4 * (cells + 2 * (size_t)P) +
         sizeof(Best) * WARPS + 16 + 2 * cells;
}

template <int NW>
int launch(const Params& prm, size_t smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(wfc_solve_kernel<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  wfc_solve_kernel<NW><<<prm.N, THREADS, smem, s>>>(prm);
  return (int)cudaGetLastError();
}

}  // namespace

// Words of a cell's pattern mask, or 0 past MAX_WORDS.
extern "C" int wfc_solve_words(int P) { return P >= 1 && P <= 64 * MAX_WORDS ? (P + 63) / 64 : 0; }

// Dynamic shared memory of one block (one wave); the launch refuses more
// than the card's per-block limit.
extern "C" long long wfc_solve_smem_bytes(int P, int W, int H, int backtracking) {
  return (long long)smem_bytes(P, W, H, wfc_solve_words(P), backtracking);
}

// grid int32 [N, W*H], ok int32 [N] and stats int32 [4, N] of N waves from
// seeds int32 [N, 2], compat uint64 [4, P, NW] (NW = wfc_solve_words(P)),
// weights float32 [P] and, for the spiral and hilbert heuristics, the
// static order float32 [W*H] (else null), on `stream`; returns the
// launch's CUDA error (0 on success).
extern "C" int wfc_solve_launch(const int32_t* seeds, const uint64_t* compat, const float* weights,
                                const float* order, int32_t* grid, int32_t* ok, int32_t* stats, int N, int P,
                                int W, int H, int periodic, int max_attempts, int loc, int choice,
                                int backtracking, void* stream) {
  const int NW = wfc_solve_words(P);
  if (N < 0 || W < 1 || H < 1 || NW == 0 || loc < 0 || loc > kHilbert || choice < 0 || choice > kMostCommon)
    return (int)cudaErrorInvalidValue;
  if ((loc == kSpiral || loc == kHilbert) && order == nullptr) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  const size_t smem = smem_bytes(P, W, H, NW, backtracking);
  int device = 0, limit = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (smem > (size_t)limit) return (int)cudaErrorInvalidConfiguration;
  const Params prm{seeds, compat, weights, order, grid, ok, stats, N, P, W, H, periodic, max_attempts, loc, choice,
                   backtracking};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (NW) {
    case 1: return launch<1>(prm, smem, s);
    case 2: return launch<2>(prm, smem, s);
    case 3: return launch<3>(prm, smem, s);
    default: return launch<4>(prm, smem, s);
  }
}
