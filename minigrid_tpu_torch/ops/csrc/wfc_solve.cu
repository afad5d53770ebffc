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
// What bounds it on this card: each wave is a serial chain of a few hundred
// collapse steps (about 300 for a 23x23 MazeSimple wave), each a location
// choice, a draw and a propagation, so the solver is latency-bound: the
// bytes it must move (the tables in, the grids and counters out) and its
// integer work are far below the card's rates.  The design keeps every
// step short and keeps many chains in flight:
//
// * One warp a wave, several waves a block.  A block loads the support
//   table, the weights and the neighbour table into shared memory once,
//   then its warps take waves from the block's range through a shared
//   counter until the range is done (a warp that finishes a short wave takes
//   the next), each wave's masks, scores, preferences, work list and, with
//   backtracking, its snapshot in the warp's own slice of shared memory.
//   The one block barrier is before any wave starts; every decision in the
//   collapse loop is warp-wide (ballots, shuffles, __reduce_*_sync).
//   wfc_layout fixes the slices and the waves a block from the shared memory
//   a wave needs; at N up to the SM count a block holds one wave, so the
//   waves spread over the SMs.
// * Propagation on a work list.  A cell whose mask shrank is queued once (a
//   queued bit per cell, a ring of cell indices); a round takes up to 8
//   queued cells, four lanes each, and lane d of a cell's four pushes its
//   constraint onto its neighbour in direction d (the four pushes side by
//   side, not one after another): the patterns that neighbour may keep are the
//   union, over the cell's remaining patterns q, of support[q][d] (built by
//   the wrapper from adj transposed: bit p set where adj[(d+2)%4][p][q]),
//   ANDed into the neighbour's mask by 32-bit atomics on the halves that
//   lose a pattern (a neighbour may take pushes from two lanes at once),
//   which queue the neighbour if it shrank.  The cost is set by the popcounts of the cells that changed.
//   Removal only drops patterns without support in a superset of the final
//   wave, and every change queues the cell again, so the list ends at the
//   unique arc-consistent fixed point the plain version's sweeps reach.  A
//   cell left empty empties its neighbours and so the whole (connected)
//   grid: the list stops at the first and the wave is emptied.  At a
//   non-periodic border the missing neighbour holds every pattern, which
//   the fresh wave's masks already account for (wave0 below); neighbour
//   indices come from the block's table.
// * Incremental location choice.  A cell's score (the heuristic's float,
//   +inf once resolved) is rewritten only when its mask changes; the
//   arg-min is a pass over the scores and two __reduce_min_sync (the score's
//   order key, then the first index among the ties).
// * The draw stays exact: lane 0 walks the chosen mask's patterns in order
//   with the plain version's float64 cumulative sum, up to the pick; the uniform words of
//   32 steps are drawn at once, one a lane.  Rarest and most-common take
//   global per-pattern counts from ballots over 32 cells at a time.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "prng.cuh"

namespace {

constexpr int MAX_WORDS = 4;  // up to 256 patterns
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NONE = 0x7fffffffu;
// Counter words of the draws: (attempt, step) for a pattern choice,
// (attempt, PREF_COUNTER | cell) for a cell's preference.
constexpr uint32_t PREF_COUNTER = 0x40000000u;
// Shared memory a block keeps off the layout (the instrumented copy's
// static arrays).
constexpr int SMEM_RESERVE = 256;

enum Loc { kEntropy = 0, kAntiEntropy, kRandom, kSimple, kLexical, kSpiral, kHilbert };
enum Choice { kWeighted = 0, kChoiceRandom, kChoiceLexical, kRarest, kMostCommon };
enum Phase { kInit = 0, kLocation, kDraw, kSnapshot, kPropagation, kOther };

__constant__ int kDX[4] = {0, 1, 0, -1};
__constant__ int kDY[4] = {-1, 0, 1, 0};

// Waves (warps) a block at most: the launch bound leaves 85 registers a
// thread at one word a cell, 128 above.
__host__ __device__ constexpr int max_waves(int NW) { return NW == 1 ? 24 : 16; }

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// The shared memory of a block: its part (the next-wave counter, the support
// table [P][4][NW], the weights [P] as float64, the neighbour table [cells]
// of four int16) and, per wave, its slice: masks [cells][NW], the snapshot's
// masks (backtracking), scores [cells], the snapshot's scores (backtracking),
// preferences [cells], the work list's ring [cells] of uint16 and its queued
// bits [ceil(cells / 32)].  Offsets in bytes.
struct Layout {
  size_t support, weights, nbr, block;
  size_t masks, snap, score, snap_score, prefs, queue, queued, wave;
};

__host__ __device__ inline Layout wfc_layout(int P, int cells, int NW, int backtracking) {
  const size_t bt = backtracking ? 1 : 0, c = (size_t)cells;
  Layout L;
  L.support = 16;
  L.weights = align16(L.support + 32 * (size_t)P * NW);
  L.nbr = align16(L.weights + 8 * (size_t)P);
  L.block = align16(L.nbr + 8 * c);
  L.masks = 0;
  L.snap = align16(L.masks + 8 * c * NW);
  L.score = align16(L.snap + bt * 8 * c * NW);
  L.snap_score = align16(L.score + 4 * c);
  L.prefs = align16(L.snap_score + bt * 4 * c);
  L.queue = align16(L.prefs + 4 * c);
  L.queued = align16(L.queue + 2 * c);
  L.wave = align16(L.queued + 4 * ((c + 31) / 32));
  return L;
}

// Waves a block for N waves on `sms` SMs within `limit` bytes of shared
// memory a block: as many as fit (at most max_waves), but no more than
// ceil(N / sms), so that small batches spread one wave a block; 0 if one
// wave does not fit.
inline int waves_per_block(const Layout& L, int NW, long long N, int sms, long long limit) {
  const long long room = limit - SMEM_RESERVE - (long long)L.block;
  if (room < (long long)L.wave) return 0;
  long long fit = room / (long long)L.wave;
  if (fit > max_waves(NW)) fit = max_waves(NW);
  long long spread = (N + sms - 1) / sms;
  if (spread < 1) spread = 1;
  return (int)(fit < spread ? fit : spread);
}

struct Params {
  const int32_t* seeds;     // [N, 2]
  const uint64_t* support;  // [P, 4, NW]
  const float* weights;     // [P]
  const float* order;       // [W*H] static cell order, or nullptr
  int32_t* grid;            // [N, W*H]
  int32_t* ok;              // [N]
  int32_t* stats;           // [4, N]: attempts, collapses, backtracks, contradictions
  int N, P, W, H, periodic, max_attempts, loc, choice, backtracking;
};

#ifdef WFC_SPLIT
// The instrumented copy's phase clock (lane 0's), summed over a warp's waves.
struct Probe {
  long long t = 0, t0 = 0;
  unsigned long long acc[6] = {0, 0, 0, 0, 0, 0};
  unsigned long long rounds = 0, cells = 0, waves = 0;
  __device__ void begin() { t = t0 = clock64(); }
  __device__ void mark(int phase) {
    const long long now = clock64();
    acc[phase] += (unsigned long long)(now - t);
    t = now;
  }
  __device__ void round(int popped) {
    ++rounds;
    cells += popped;
  }
};
#else
struct Probe {
  __device__ void begin() {}
  __device__ void mark(int) {}
  __device__ void round(int) {}
};
#endif

__device__ __forceinline__ double uniform53(minigrid::Words w) {
  const uint64_t bits = ((uint64_t)(w.w0 >> 5) << 26) | (uint64_t)(w.w1 >> 6);
  return (double)bits * (1.0 / 9007199254740992.0);
}

__device__ __forceinline__ uint64_t reduce_or64(uint64_t x) {
  return (uint64_t)__reduce_or_sync(FULL, (unsigned)x) | ((uint64_t)__reduce_or_sync(FULL, (unsigned)(x >> 32)) << 32);
}

// The location score of a cell with `count` patterns (+inf once resolved or
// empty); the arg-min, first index on ties, is the plain version's choice
// (arg-max of the unnegated score for anti-entropy).
__device__ __forceinline__ float score_of(int count, float pref, int loc) {
  if (count <= 1) return INFINITY;
  float s;
  if (loc == kEntropy || loc == kAntiEntropy) {
    s = __fadd_rn(pref, (float)count);
  } else if (loc == kSimple) {
    s = (float)count;
  } else {
    s = pref;
  }
  return loc == kAntiEntropy ? -s : s;
}

// An unsigned key in the order of the float (equal floats, equal keys).
__device__ __forceinline__ unsigned order_key(float s) {
  const unsigned b = __float_as_uint(__fadd_rn(s, 0.0f));  // -0 as +0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

template <int NW>
__device__ __forceinline__ int first_pattern(const uint64_t (&m)[NW]) {
  int first = 0;
#pragma unroll
  for (int w = NW - 1; w >= 0; --w) {
    if (m[w]) first = w * 64 + __ffsll((long long)m[w]) - 1;
  }
  return first;
}

// Lane 0's inverse-CDF draw over the patterns of `m` in order, with
// probabilities weights[p] (or 1): the first whose float64 cumulative sum
// exceeds u times the total, as the plain version's cumulative sum over all
// P patterns, whose absent ones add 0.  That pattern has a probability above
// 0 (the sum grew there), so the walk stops at it; past the end it is the
// last pattern of probability above 0 (P - 1 if none).  Weights are read two
// at a time and added in order.
template <int NW>
__device__ int categorical(double u, const uint64_t (&m)[NW], const double* weights, bool ones, int P) {
  double total = 0.0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    for (uint64_t bits = m[w]; bits;) {
      const int p0 = w * 64 + __ffsll((long long)bits) - 1;
      bits &= bits - 1;
      const bool two = bits != 0;
      const int p1 = two ? w * 64 + __ffsll((long long)bits) - 1 : p0;
      bits &= bits - 1;
      const double a = ones ? 1.0 : weights[p0], b = ones ? 1.0 : weights[p1];
      total += a;
      if (two) total += b;
    }
  }
  const double x = u * total;
  double c = 0.0;
  int last = -1;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    for (uint64_t bits = m[w]; bits; bits &= bits - 1) {
      const int p = w * 64 + __ffsll((long long)bits) - 1;
      const double q = ones ? 1.0 : weights[p];
      c += q;
      if (q > 0.0) last = p;
      if (c > x) return p;
    }
  }
  return last < 0 ? P - 1 : last;
}

// A wave's slice of shared memory and its work list (head and count are
// the same on every lane).
template <int NW>
struct Wave {
  uint64_t* m;
  uint64_t* snap;
  float* score;
  float* snap_score;
  float* prefs;
  uint16_t* queue;
  uint32_t* queued;
  int cells, words, head, count;

  __device__ Wave(unsigned char* base, const Layout& L, int cells_)
      : m(reinterpret_cast<uint64_t*>(base + L.masks)),
        snap(reinterpret_cast<uint64_t*>(base + L.snap)),
        score(reinterpret_cast<float*>(base + L.score)),
        snap_score(reinterpret_cast<float*>(base + L.snap_score)),
        prefs(reinterpret_cast<float*>(base + L.prefs)),
        queue(reinterpret_cast<uint16_t*>(base + L.queue)),
        queued(reinterpret_cast<uint32_t*>(base + L.queued)),
        cells(cells_),
        words((cells_ + 31) / 32),
        head(0),
        count(0) {}

  // Warp-wide: appends the cell c of each lane with `want` whose queued bit
  // was clear (a cell is in the list at most once, so the ring never holds
  // more than `cells`).
  __device__ __forceinline__ void enqueue(bool want, int c, int lane) {
    bool fresh = false;
    if (want) {
      const uint32_t bit = 1u << (c & 31);
      fresh = !(atomicOr(&queued[c >> 5], bit) & bit);
    }
    const unsigned b = __ballot_sync(FULL, fresh);
    if (fresh) {
      int pos = head + count + __popc(b & ((1u << lane) - 1u));
      if (pos >= cells) pos -= cells;
      queue[pos] = (uint16_t)c;
    }
    count += __popc(b);
  }

  // Warp-wide: drops the work list.
  __device__ __forceinline__ void clear_list(int lane) {
    for (int i = lane; i < words; i += 32) queued[i] = 0u;
    head = count = 0;
  }

  // Warp-wide: the work list to its fixed point; true if a cell was left
  // with no pattern (then the list is dropped and every mask emptied).  A
  // round takes up to 8 queued cells, a group of four lanes each: lane d of
  // the group pushes the cell's constraint onto its neighbour in direction d.
  __device__ bool propagate(const uint64_t* support, const short* nbr, int loc, int lane, Probe& probe) {
    const int slot = lane >> 2, d = lane & 3;
    while (count > 0) {
      const int take = min(32 / 4, count);
      int c = -1;
      if (slot < take) {
        int pos = head + slot;
        if (pos >= cells) pos -= cells;
        c = queue[pos];
      }
      head += take;
      if (head >= cells) head -= cells;
      count -= take;
      probe.round(take);
      // The patterns the neighbour may keep: the union over the cell's
      // patterns q of support[q][d], two rows a step.
      uint64_t allow[NW];
#pragma unroll
      for (int w = 0; w < NW; ++w) allow[w] = 0;
      int y = -1;
      bool empty = false;
      if (c >= 0) {
        uint64_t cm[NW];
        int n = 0;
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          cm[w] = m[c * NW + w];
          n += __popcll(cm[w]);
        }
        if (d == 0) score[c] = score_of(n, prefs[c], loc);
        empty = n == 0;
        y = nbr[4 * c + d];
        const uint64_t* col = support + d * NW;
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          uint64_t bits = cm[w];
          while (bits) {
            const int q0 = w * 64 + __ffsll((long long)bits) - 1;
            bits &= bits - 1;
            const int q1 = bits ? w * 64 + __ffsll((long long)bits) - 1 : q0;
            bits &= bits - 1;
            const uint64_t* r0 = col + (size_t)q0 * 4 * NW;
            const uint64_t* r1 = col + (size_t)q1 * 4 * NW;
#pragma unroll
            for (int v = 0; v < NW; ++v) allow[v] |= r0[v] | r1[v];
          }
        }
      }
      // The cell leaves the list before any push of this round can queue
      // it again.
      if (c >= 0 && d == 0) atomicAnd(&queued[c >> 5], ~(1u << (c & 31)));
      __syncwarp();
      if (__any_sync(FULL, empty)) {
        clear_list(lane);
        for (int i = lane; i < cells * NW; i += 32) m[i] = 0ull;
        __syncwarp();
        return true;
      }
      bool shrank = false;
      if (y >= 0) {
        uint32_t* halves = reinterpret_cast<uint32_t*>(m + y * NW);
#pragma unroll
        for (int h = 0; h < 2 * NW; ++h) {
          // Masks only shrink: a read with nothing to drop means the current
          // mask has nothing to drop either.
          const uint32_t keep = (uint32_t)(allow[h >> 1] >> (32 * (h & 1)));
          if (halves[h] & ~keep) shrank |= (atomicAnd(&halves[h], keep) & ~keep) != 0;
        }
      }
      enqueue(shrank, y, lane);
      __syncwarp();
    }
    return false;
  }
};

// One wave, solved by the calling warp.
template <int NW>
__device__ void solve(const Params& prm, Wave<NW>& v, const uint64_t* support, const double* weights,
                      const short* nbr, const uint64_t (&wave0)[NW], int id, int lane, Probe& probe) {
  const int P = prm.P, cells = v.cells, loc = prm.loc, choice = prm.choice;
  const bool backtracking = prm.backtracking != 0;
  const uint32_t k0 = (uint32_t)prm.seeds[2 * id], k1 = (uint32_t)prm.seeds[2 * id + 1];
  bool full0 = true;
  int count0 = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const int lo = w * 64, n = min(max(P - lo, 0), 64);
    full0 &= wave0[w] == (n == 64 ? ~0ull : ((1ull << n) - 1ull));
    count0 += __popcll(wave0[w]);
  }
  const int max_steps = 4 * cells;
  int attempts = 0, collapses = 0, backtracks = 0, contradictions = 0;
  bool ok = false;
  while (true) {
    // A fresh attempt: every cell wave0 (the full masks after the border
    // and the full neighbours), this attempt's preferences; if wave0 is not
    // the full masks, every cell changed and is queued.
    for (int c = lane; c < cells; c += 32) {
#pragma unroll
      for (int w = 0; w < NW; ++w) v.m[c * NW + w] = wave0[w];
      float pref = 0.0f;
      if (loc == kLexical) {
        pref = 1.0f;
      } else if (loc != kSimple) {
        const minigrid::Words r = minigrid::threefry2x32(k0, k1, (uint32_t)attempts, PREF_COUNTER | (uint32_t)c);
        pref = __fmul_rn((float)(r.w0 >> 8) * 5.9604644775390625e-8f, 0.1f);
        if ((loc == kSpiral || loc == kHilbert) && !(prm.order[c] > 1.5f)) pref = prm.order[c];
      }
      v.prefs[c] = pref;
      v.score[c] = score_of(count0, pref, loc);
      if (!full0) v.queue[c] = (uint16_t)c;
    }
    for (int i = lane; i < v.words; i += 32) {
      const int rest = cells - 32 * i;
      v.queued[i] = full0 ? 0u : (rest >= 32 ? FULL : (1u << rest) - 1u);
    }
    v.head = 0;
    v.count = full0 ? 0 : cells;
    __syncwarp();
    probe.mark(kInit);
    bool failed = v.propagate(support, nbr, loc, lane, probe);
    probe.mark(kPropagation);
    int steps = 0;
    bool solved = false;
    double u_lane = 0.0;
    while (true) {
      // The location: each lane's first best over its cells, then the
      // warp's least key and the first cell holding it.
      float best = INFINITY;
      unsigned best_cell = NONE;
#pragma unroll 4
      for (int c = lane; c < cells; c += 32) {
        const float s = v.score[c];
        if (s < best) {
          best = s;
          best_cell = (unsigned)c;
        }
      }
      const unsigned key = order_key(best);
      const unsigned least = __reduce_min_sync(FULL, key);
      const unsigned cell = __reduce_min_sync(FULL, key == least ? best_cell : NONE);
      probe.mark(kLocation);
      // Every cell resolved (an empty one fails the attempt instead).
      solved = !failed && cell == NONE;
      if (solved || failed || steps >= max_steps) break;
      if ((steps & 31) == 0) {
        u_lane = uniform53(minigrid::threefry2x32(k0, k1, (uint32_t)attempts, (uint32_t)(steps + lane)));
      }
      const double u = __shfl_sync(FULL, u_lane, steps & 31);
      uint64_t pick_from[NW];
      if (choice == kRarest || choice == kMostCommon) {
        // Global possibility counts, not masked by the cell's domain; the
        // maximum for rarest, the minimum for most-common (as the JAX
        // package has them).  Lane l counts the patterns 32 j + l.
        int sums[2 * NW];
#pragma unroll
        for (int j = 0; j < 2 * NW; ++j) sums[j] = 0;
        for (int base = 0; base < cells; base += 32) {
          const int c = base + lane;
#pragma unroll
          for (int j = 0; j < 2 * NW; ++j) {
            const uint32_t half = c < cells ? (uint32_t)(v.m[c * NW + (j >> 1)] >> (32 * (j & 1))) : 0u;
            for (int l = 0; l < 32 && 32 * j + l < P; ++l) {
              const int n = __popc(__ballot_sync(FULL, (half >> l) & 1u));
              if (lane == l) sums[j] += n;
            }
          }
        }
        const bool rarest = choice == kRarest;
        int mine = rarest ? -1 : 0x7fffffff;
#pragma unroll
        for (int j = 0; j < 2 * NW; ++j) {
          if (32 * j + lane < P) mine = rarest ? max(mine, sums[j]) : min(mine, sums[j]);
        }
        const int target = rarest ? __reduce_max_sync(FULL, mine) : __reduce_min_sync(FULL, mine);
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          const unsigned lo = __ballot_sync(FULL, 64 * w + lane < P && sums[2 * w] == target);
          const unsigned hi = __ballot_sync(FULL, 64 * w + 32 + lane < P && sums[2 * w + 1] == target);
          pick_from[w] = (uint64_t)lo | ((uint64_t)hi << 32);
        }
      } else {
#pragma unroll
        for (int w = 0; w < NW; ++w) pick_from[w] = v.m[cell * NW + w];
      }
      int pattern = 0;
      if (lane == 0) {
        pattern = choice == kChoiceLexical ? first_pattern(pick_from)
                                           : categorical(u, pick_from, weights, choice != kWeighted, P);
      }
      pattern = __shfl_sync(FULL, pattern, 0);
      probe.mark(kDraw);
      if (backtracking) {
        for (int i = lane; i < cells * NW; i += 32) v.snap[i] = v.m[i];
        for (int c = lane; c < cells; c += 32) v.snap_score[c] = v.score[c];
        probe.mark(kSnapshot);
      }
      if (lane == 0) {
#pragma unroll
        for (int w = 0; w < NW; ++w) v.m[cell * NW + w] = w == (pattern >> 6) ? 1ull << (pattern & 63) : 0ull;
      }
      v.enqueue(lane == 0, (int)cell, lane);
      __syncwarp();
      probe.mark(kOther);
      bool contradiction = v.propagate(support, nbr, loc, lane, probe);
      if (backtracking && contradiction) {
        // Pop the entry snapshot and ban the choice; the ban's own
        // contradiction fails the attempt.
        ++backtracks;
        for (int i = lane; i < cells * NW; i += 32) v.m[i] = v.snap[i];
        for (int c = lane; c < cells; c += 32) v.score[c] = v.snap_score[c];
        __syncwarp();
        if (lane == 0) v.m[cell * NW + (pattern >> 6)] &= ~(1ull << (pattern & 63));
        v.enqueue(lane == 0, (int)cell, lane);
        __syncwarp();
        contradiction = v.propagate(support, nbr, loc, lane, probe);
      }
      failed = contradiction;
      ++steps;
      ++collapses;
      probe.mark(kPropagation);
    }
    ok = solved && !failed;
    ++attempts;
    contradictions += !ok;
    if (ok || attempts > prm.max_attempts) break;
  }
  // The grid: each cell's first possible pattern (0 where none is left).
  for (int c = lane; c < cells; c += 32) {
    uint64_t cm[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) cm[w] = v.m[c * NW + w];
    prm.grid[(size_t)id * cells + c] = first_pattern(cm);
  }
  if (lane == 0) {
    prm.ok[id] = ok;
    prm.stats[id] = attempts;
    prm.stats[prm.N + id] = collapses;
    prm.stats[2 * prm.N + id] = backtracks;
    prm.stats[3 * prm.N + id] = contradictions;
  }
  probe.mark(kOther);
}

template <int NW>
__global__ void __launch_bounds__(32 * max_waves(NW)) wfc_solve_kernel(Params prm) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = prm.P, W = prm.W, H = prm.H, cells = W * H;
  const Layout L = wfc_layout(P, cells, NW, prm.backtracking);
  int* next = reinterpret_cast<int*>(smem);
  uint64_t* support = reinterpret_cast<uint64_t*>(smem + L.support);
  double* weights = reinterpret_cast<double*>(smem + L.weights);
  short* nbr = reinterpret_cast<short*>(smem + L.nbr);
  for (int i = threadIdx.x; i < 4 * P * NW; i += blockDim.x) support[i] = prm.support[i];
  for (int p = threadIdx.x; p < P; p += blockDim.x) weights[p] = (double)prm.weights[p];
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    const int x = c / H, y = c % H;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      int nx = x + kDX[d], ny = y + kDY[d];
      if (prm.periodic) {
        nx = (nx + W) % W;
        ny = (ny + H) % H;
        nbr[4 * c + d] = (short)(nx * H + ny);
      } else {
        nbr[4 * c + d] = (nx < 0 || nx >= W || ny < 0 || ny >= H) ? (short)-1 : (short)(nx * H + ny);
      }
    }
  }
  if (threadIdx.x == 0) *next = 0;
  __syncthreads();  // the only block barrier: the tables are in

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // The block's range of waves (ranges differ by at most one wave).
  const int begin = (int)((long long)blockIdx.x * prm.N / gridDim.x);
  const int end = (int)((long long)(blockIdx.x + 1) * prm.N / gridDim.x);
  // wave0: the full masks ANDed, in every direction, with the patterns
  // that some pattern supports (a border's missing neighbour, and every
  // neighbour of a fresh wave, holds every pattern).
  uint64_t wave0[NW];
  {
    uint64_t any[4][NW];
#pragma unroll
    for (int d = 0; d < 4; ++d) {
#pragma unroll
      for (int w = 0; w < NW; ++w) any[d][w] = 0;
    }
    for (int q = lane; q < P; q += 32) {
#pragma unroll
      for (int d = 0; d < 4; ++d) {
#pragma unroll
        for (int w = 0; w < NW; ++w) any[d][w] |= support[(q * 4 + d) * NW + w];
      }
    }
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const int lo = w * 64, n = min(max(P - lo, 0), 64);
      wave0[w] = n == 64 ? ~0ull : ((1ull << n) - 1ull);
#pragma unroll
      for (int d = 0; d < 4; ++d) wave0[w] &= reduce_or64(any[d][w]);
    }
  }
  Wave<NW> v(smem + L.block + (size_t)warp * L.wave, L, cells);
  Probe probe;
  probe.begin();
  while (true) {
    int id = 0;
    if (lane == 0) id = begin + atomicAdd(next, 1);
    id = __shfl_sync(FULL, id, 0);
    if (id >= end) break;
    solve<NW>(prm, v, support, weights, nbr, wave0, id, lane, probe);
#ifdef WFC_SPLIT
    ++probe.waves;
#endif
  }
#ifdef WFC_SPLIT
  // The waits: the cycles each warp holds its slice after its last wave,
  // until the block's last warp ends.
  __shared__ long long split_end[32];
  const long long done = clock64();
  if (lane == 0) split_end[warp] = done;
  __syncthreads();
  if (lane == 0) {
    long long last = done;
    for (int k = 0; k < (int)(blockDim.x >> 5); ++k) last = max(last, split_end[k]);
    for (int i = 0; i < 6; ++i) atomicAdd(&g_split[i], probe.acc[i]);
    atomicAdd(&g_split[7], probe.waves);
    atomicAdd(&g_split[8], (unsigned long long)(last - done));
    atomicAdd(&g_split[9], (unsigned long long)(last - probe.t0));
    atomicAdd(&g_split[10], probe.rounds);
    atomicAdd(&g_split[11], probe.cells);
  }
#endif
}

template <int NW>
int launch(const Params& prm, const Layout& L, int sms, int limit, cudaStream_t s) {
  const int per_block = waves_per_block(L, NW, prm.N, sms, limit);
  if (per_block == 0) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = L.block + (size_t)per_block * L.wave;
  const int threads = 32 * per_block;
  cudaError_t err = cudaFuncSetAttribute(wfc_solve_kernel<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // Blocks: as many as the SMs hold at once, but no more than it takes to
  // give each warp a wave; each block's warps share a range of about N /
  // blocks waves.
  int resident = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, wfc_solve_kernel<NW>, threads, smem);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (long long)sms * (resident > 0 ? resident : 1);
  const long long needed = (prm.N + per_block - 1) / per_block;
  if (blocks > needed) blocks = needed;
  wfc_solve_kernel<NW><<<(unsigned)blocks, threads, smem, s>>>(prm);
  return (int)cudaGetLastError();
}

}  // namespace

// Words of a cell's pattern mask, or 0 past MAX_WORDS.
extern "C" int wfc_solve_words(int P) { return P >= 1 && P <= 64 * MAX_WORDS ? (P + 63) / 64 : 0; }

// Dynamic shared memory of a block of one wave: the least a launch needs.
extern "C" long long wfc_solve_smem_bytes(int P, int W, int H, int backtracking) {
  const Layout L = wfc_layout(P, W * H, wfc_solve_words(P), backtracking);
  return (long long)(L.block + L.wave);
}

// The launch's layout for N waves on `sms` SMs within `limit` bytes of
// shared memory a block: out = {a block's own bytes, a wave's bytes, waves a
// block, a block's dynamic shared memory}.  Returns 0, or
// cudaErrorInvalidConfiguration (with waves a block 0) if one wave does not
// fit.
extern "C" int wfc_solve_layout(int P, int W, int H, int backtracking, long long N, int sms, long long limit,
                                long long* out) {
  const int NW = wfc_solve_words(P);
  if (NW == 0 || W < 1 || H < 1 || sms < 1) return (int)cudaErrorInvalidValue;
  const Layout L = wfc_layout(P, W * H, NW, backtracking);
  const int per_block = waves_per_block(L, NW, N, sms, limit);
  out[0] = (long long)L.block;
  out[1] = (long long)L.wave;
  out[2] = per_block;
  out[3] = (long long)(L.block + (size_t)per_block * L.wave);
  return per_block == 0 ? (int)cudaErrorInvalidConfiguration : 0;
}

// grid int32 [N, W*H], ok int32 [N] and stats int32 [4, N] of N waves from
// seeds int32 [N, 2], the support table uint64 [P, 4, NW] (NW =
// wfc_solve_words(P); bit p of row (q, d) set where adj[(d+2)%4][p][q]: the
// patterns the neighbour in direction d of a cell holding q may keep),
// weights float32 [P] and, for the spiral and hilbert heuristics, the
// static order float32 [W*H] (else null), on `stream`; returns the
// launch's CUDA error (0 on success).
extern "C" int wfc_solve_launch(const int32_t* seeds, const uint64_t* support, const float* weights,
                                const float* order, int32_t* grid, int32_t* ok, int32_t* stats, int N, int P,
                                int W, int H, int periodic, int max_attempts, int loc, int choice,
                                int backtracking, void* stream) {
  const int NW = wfc_solve_words(P);
  if (N < 0 || W < 1 || H < 1 || W * H > 32767 || NW == 0 || loc < 0 || loc > kHilbert || choice < 0 ||
      choice > kMostCommon)
    return (int)cudaErrorInvalidValue;
  if ((loc == kSpiral || loc == kHilbert) && order == nullptr) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  int device = 0, limit = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const Layout L = wfc_layout(P, W * H, NW, backtracking);
  const Params prm{seeds, support, weights, order, grid, ok, stats, N, P, W, H, periodic, max_attempts, loc, choice,
                   backtracking};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (NW) {
    case 1: return launch<1>(prm, L, sms, limit, s);
    case 2: return launch<2>(prm, L, sms, limit, s);
    case 3: return launch<3>(prm, L, sms, limit, s);
    default: return launch<4>(prm, L, sms, limit, s);
  }
}
