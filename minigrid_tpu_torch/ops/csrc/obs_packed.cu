// The batched packed egocentric observation (K4) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel minigrid_tpu/ops/obs_pallas.py::_kernel:
// for each env, the V x V view cells at world agent + f * (V-1-j) -
// r * (V/2 - i) (walls outside the grid), the reference's two-way occlusion
// flood (minigrid/core/grid.py:291-328) on the cells as they lie in the
// grid, then the carried object (or empty) at the agent cell and 0
// ("unseen") for every cell the agent cannot see.  Inputs are the state's
// own env-major grid int32 [N, W*H] and its agent_x, agent_y, agent_dir and
// carrying int32 [N]; the output is int32 [N, V, V] in the port's [i, j]
// layout (core/obs.gen_obs_packed), so the TPU wrapper's transpose has no
// counterpart.
//
// A block owns EB = 64 consecutive envs, a thread each.  The thread walks
// its env's view row by row from the agent's (j = V-1) up: it reads the
// row's V cells (view_cell), floods the row (flood_row, shared with the
// rollout kernels) and writes the row's cells into the block's output tile
// in shared memory, [EB][V*V] int32 (the tile's odd row stride V*V keeps
// the threads' writes free of bank conflicts).  After a barrier the block
// writes its tile, a contiguous slice of `out`, with 16-byte stores.  Where
// a grid has at most STAGED_MAX_CELLS cells, the block first copies its
// envs' grid rows, also one contiguous slice, into shared memory with
// 16-byte loads, each env's row at an odd stride (the envs of a warp that
// read the same cell hit distinct banks), and view_cell reads them there;
// a larger grid is read where it lies, each thread inside its own env's
// row.  Every odd V from 3 to 15, both values of see_through_walls and both
// ways of reading the grid are instantiated; the launch picks the last by
// W*H.  Views of 17 to 31 (MAX_VIEW, the widest whose row masks fit the
// 32-bit words of the flood, as the JAX package's int32 ones do) take
// obs_packed_wide_kernel: V at run time, the grid read in place, each row
// of the view read twice (once for its transparency bits, once for the
// cells the flood lit, from L1) and written straight to `out`.
//
// What bounds it on this card: bytes.  Per env it must read the V*V grid
// cells it sees and 4 scalars and write V*V cells (0.4 KB at V = 7); its
// integer work is a few hundred operations, far below the CUDA cores'
// rate.  With the stores and, on a staged grid, the loads whole 16-byte
// vectors of contiguous memory, the call moves what it must plus, on a
// staged grid, the cells of the rows that the view does not see (an 8x8
// grid's 64 cells against the 49 of a 7x7 view).  A grid read in place is
// read in the sectors of each env's own row, through L1.

#include <cuda_runtime.h>
#include <stdint.h>

#include "minigrid_env.cuh"

namespace {

using namespace minigrid;

constexpr int EB = 64;  // envs per block
// Grids of at most this many cells are staged in shared memory (an env's
// row of up to 101 words, 26 KB a block).
constexpr int STAGED_MAX_CELLS = 100;

// Dynamic shared memory of a block: the output tile and, staged, the grid
// rows at an odd stride.
template <int V, bool STAGED>
int smem_bytes(int WH) {
  return EB * V * V * 4 + (STAGED ? EB * (WH | 1) * 4 : 0);
}

template <int V, bool SEE_THROUGH, bool STAGED>
__global__ void __launch_bounds__(EB)
    obs_packed_kernel(const int* __restrict__ grid, const int* __restrict__ ax, const int* __restrict__ ay,
                      const int* __restrict__ dir, const int* __restrict__ carrying, int* __restrict__ out, int N,
                      int W, int H) {
  constexpr int V2 = V * V;
  extern __shared__ __align__(16) int smem[];
  int* tile = smem;  // [EB][V2]
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * EB;
  const int valid = min(EB, N - n0);
  const int n = n0 + tid;
  const int WH = W * H;
  const int* g;
  if constexpr (STAGED) {
    // The block's grid rows, grid[n0 * WH, (n0 + valid) * WH), into rows
    // of P words: cell k of the slice goes to row k / WH (k / WH as
    // __umulhi(k, ceil(2^32 / WH)), exact for k * WH < 2^32 / WH).
    const int P = WH | 1;
    int* stage = smem + EB * V2;
    const int* src = grid + (size_t)n0 * WH;
    const int count = valid * WH;
    const uint32_t magic = 0xFFFFFFFFu / (uint32_t)WH + 1u;
    auto put = [&](int k, int v) {
      const int r = (int)__umulhi((uint32_t)k, magic);
      stage[r * P + k - r * WH] = v;
    };
    const int head = min(count, (int)(((16u - ((uintptr_t)src & 15u)) & 15u) >> 2));
    for (int k = tid; k < head; k += EB) put(k, src[k]);
    const int nvec = (count - head) >> 2;
    const int4* vsrc = reinterpret_cast<const int4*>(src + head);
    for (int q = tid; q < nvec; q += EB) {
      const int4 v = vsrc[q];
      const int k = head + 4 * q;
      put(k, v.x);
      put(k + 1, v.y);
      put(k + 2, v.z);
      put(k + 3, v.w);
    }
    for (int k = head + 4 * nvec + tid; k < count; k += EB) put(k, src[k]);
    __syncthreads();
    g = stage + tid * P;
  } else {
    g = grid + (size_t)n * WH;
  }
  if (tid < valid) {
    const ViewFrame f = view_frame(ax[n], ay[n], dir[n]);
    const int carry = carrying[n];
    int* o = tile + tid * V2;
    int up = 1 << (V / 2);
#pragma unroll
    for (int j = V - 1; j >= 0; --j) {
      int row[V];
      int t = 0;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        row[i] = view_cell<V>(g, 1, W, H, f, i, j);
        t |= see_behind(row[i]) ? (1 << i) : 0;
      }
      // The agent cell is lit whatever the flood: `up` seeds row V-1 with it.
      const int lit = SEE_THROUGH ? (1 << V) - 1 : flood_row<V>(t, up);
      if (j == V - 1) row[V / 2] = carry != 0 ? (carry & 0xFFFF) : OBJ_EMPTY;
#pragma unroll
      for (int i = 0; i < V; ++i) o[i * V + j] = ((lit >> i) & 1) ? row[i] : 0;
    }
  }
  __syncthreads();
  // The tile is out[n0 .. n0 + valid), 16-byte aligned (n0 * V2 a multiple
  // of 4, `out` 16-byte aligned).
  int* dst = out + (size_t)n0 * V2;
  const int count = valid * V2;
  const int nvec = count >> 2;
  for (int q = tid; q < nvec; q += EB) reinterpret_cast<int4*>(dst)[q] = reinterpret_cast<const int4*>(tile)[q];
  for (int k = 4 * nvec + tid; k < count; k += EB) dst[k] = tile[k];
}

// The flood of one view row at run-time V (flood_row with 32-bit unsigned
// masks, whose wraparound keeps the low V bits exact up to V = 32).
__device__ __forceinline__ uint32_t flood_row_wide(uint32_t t, uint32_t& up, int V) {
  const uint32_t full = V >= 32 ? 0xFFFFFFFFu : (1u << V) - 1u;
  const uint32_t m_r = up | ((((up & t) + t) & full) ^ t);
  const uint32_t cond_r = m_r & t & (full >> 1);
  const uint32_t new_up = cond_r | ((cond_r << 1) & full);
  uint32_t m_l = m_r;
  for (int k = 0; k < V - 1; ++k) m_l |= (m_l & t) >> 1;
  const uint32_t cond_l = m_l & t & ~1u;
  up = new_up | cond_l | (cond_l >> 1);
  return m_l;
}

constexpr int MAX_VIEW = 31;
constexpr int WIDE_THREADS = 128;

template <bool SEE_THROUGH>
__global__ void __launch_bounds__(WIDE_THREADS)
    obs_packed_wide_kernel(const int* __restrict__ grid, const int* __restrict__ ax, const int* __restrict__ ay,
                           const int* __restrict__ dir, const int* __restrict__ carrying, int* __restrict__ out, int N,
                           int W, int H, int V) {
  const int n = blockIdx.x * WIDE_THREADS + threadIdx.x;
  if (n >= N) return;
  const int* g = grid + (size_t)n * W * H;
  int* o = out + (size_t)n * V * V;
  const int d = dir[n];
  const int fx = (d == 0) - (d == 2), fy = (d == 1) - (d == 3);
  const int x0 = ax[n], y0 = ay[n], half = V / 2;
  // World cell of view cell (i, j): agent + f * (V-1-j) - r * (V/2 - i),
  // r = (-fy, fx); a wall outside the grid (view_cell).
  auto cell = [&](int i, int j) {
    const int wx = x0 + fx * (V - 1 - j) + fy * (half - i);
    const int wy = y0 + fy * (V - 1 - j) - fx * (half - i);
    return wx >= 0 && wx < W && wy >= 0 && wy < H ? g[wx * H + wy] : WALL_CELL;
  };
  const int carry = carrying[n];
  uint32_t up = 1u << half;
  for (int j = V - 1; j >= 0; --j) {
    uint32_t lit = 0xFFFFFFFFu;
    if (!SEE_THROUGH) {
      uint32_t t = 0;
      for (int i = 0; i < V; ++i) t |= see_behind(cell(i, j)) ? 1u << i : 0u;
      lit = flood_row_wide(t, up, V);
    }
    for (int i = 0; i < V; ++i) {
      int v = (i == half && j == V - 1) ? (carry != 0 ? (carry & 0xFFFF) : OBJ_EMPTY) : cell(i, j);
      o[i * V + j] = (lit >> i) & 1u ? v : 0;
    }
  }
}

template <int V, bool SEE_THROUGH, bool STAGED>
cudaError_t launch_case(const int* grid, const int* ax, const int* ay, const int* dir, const int* carrying,
                        int* out, int N, int W, int H, cudaStream_t stream) {
  const int bytes = smem_bytes<V, STAGED>(W * H);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(obs_packed_kernel<V, SEE_THROUGH, STAGED>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (N + EB - 1) / EB;
  obs_packed_kernel<V, SEE_THROUGH, STAGED><<<blocks, EB, bytes, stream>>>(grid, ax, ay, dir, carrying, out, N, W, H);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_v(const int* grid, const int* ax, const int* ay, const int* dir, const int* carrying, int* out,
                     int N, int W, int H, bool see_through, cudaStream_t s) {
  const int wh = W * H;
  const bool staged = wh >= 2 && wh <= STAGED_MAX_CELLS;
  if (see_through) {
    return staged ? launch_case<V, true, true>(grid, ax, ay, dir, carrying, out, N, W, H, s)
                  : launch_case<V, true, false>(grid, ax, ay, dir, carrying, out, N, W, H, s);
  }
  return staged ? launch_case<V, false, true>(grid, ax, ay, dir, carrying, out, N, W, H, s)
                : launch_case<V, false, false>(grid, ax, ay, dir, carrying, out, N, W, H, s);
}

}  // namespace

// Whether the kernels take view size V: every odd V from 3 to MAX_VIEW.
extern "C" int obs_packed_supports_view(int V) { return V >= 3 && V <= MAX_VIEW && V % 2 == 1; }

// Whether the grid of a W x H env is staged in shared memory.
extern "C" int obs_packed_staged(int W, int H) { return W * H >= 2 && W * H <= STAGED_MAX_CELLS; }

// out int32 [N, V, V] (16-byte aligned) from grid int32 [N, W*H] and ax,
// ay, dir, carrying int32 [N], on `stream`; returns the launch's CUDA error
// (0 on success).
extern "C" int obs_packed_launch(const int* grid, const int* ax, const int* ay, const int* dir,
                                 const int* carrying, int* out, int N, int W, int H, int V, int see_through,
                                 void* stream) {
  if (N < 0 || W < 1 || H < 1 || !obs_packed_supports_view(V)) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)out & 15u) != 0) return (int)cudaErrorMisalignedAddress;
  if (N == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool st = see_through != 0;
  switch (V) {
    case 3: return (int)launch_v<3>(grid, ax, ay, dir, carrying, out, N, W, H, st, s);
    case 5: return (int)launch_v<5>(grid, ax, ay, dir, carrying, out, N, W, H, st, s);
    case 7: return (int)launch_v<7>(grid, ax, ay, dir, carrying, out, N, W, H, st, s);
    case 9: return (int)launch_v<9>(grid, ax, ay, dir, carrying, out, N, W, H, st, s);
    case 11: return (int)launch_v<11>(grid, ax, ay, dir, carrying, out, N, W, H, st, s);
    case 13: return (int)launch_v<13>(grid, ax, ay, dir, carrying, out, N, W, H, st, s);
    case 15: return (int)launch_v<15>(grid, ax, ay, dir, carrying, out, N, W, H, st, s);
  }
  const int blocks = (N + WIDE_THREADS - 1) / WIDE_THREADS;
  if (st) {
    obs_packed_wide_kernel<true><<<blocks, WIDE_THREADS, 0, s>>>(grid, ax, ay, dir, carrying, out, N, W, H, V);
  } else {
    obs_packed_wide_kernel<false><<<blocks, WIDE_THREADS, 0, s>>>(grid, ax, ay, dir, carrying, out, N, W, H, V);
  }
  return (int)cudaGetLastError();
}
