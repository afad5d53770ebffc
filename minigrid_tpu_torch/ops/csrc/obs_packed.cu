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
// One thread owns one env and walks its view row by row from the agent's
// (j = V-1) up: it reads the row's V cells (view_cell, stride 1), floods the
// row (flood_row, shared with the rollout kernels), and writes the row out,
// so it holds one row of cells in registers and no V x V tile.  Every odd V
// from 3 to 15 and both values of see_through_walls are instantiated.
//
// What bounds it on this card: bytes.  Per env it must read V*V grid cells
// and 4 scalars and write V*V cells (0.4 KB at V = 7); its integer work is a
// few hundred operations, far below the CUDA cores' rate.  This first
// version leaves the layout as it is: a thread's reads fall inside its own
// env's W*H row (neighbouring threads read neighbouring rows, through L1),
// and its stores are strided by V*V words across the warp.  Staging a
// block's output in shared memory to write it coalesced is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "minigrid_env.cuh"

namespace {

using namespace minigrid;

constexpr int THREADS = 256;

template <int V, bool SEE_THROUGH>
__global__ void __launch_bounds__(THREADS)
    obs_packed_kernel(const int* __restrict__ grid, const int* __restrict__ ax, const int* __restrict__ ay,
                      const int* __restrict__ dir, const int* __restrict__ carrying, int* __restrict__ out, int N,
                      int W, int H) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const int* g = grid + (size_t)n * W * H;
  const ViewFrame f = view_frame(ax[n], ay[n], dir[n]);
  const int carry = carrying[n];
  int* o = out + (size_t)n * V * V;
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

template <int V>
cudaError_t launch_v(const int* grid, const int* ax, const int* ay, const int* dir, const int* carrying, int* out,
                     int N, int W, int H, bool see_through, cudaStream_t stream) {
  const int blocks = (N + THREADS - 1) / THREADS;
  if (see_through) {
    obs_packed_kernel<V, true><<<blocks, THREADS, 0, stream>>>(grid, ax, ay, dir, carrying, out, N, W, H);
  } else {
    obs_packed_kernel<V, false><<<blocks, THREADS, 0, stream>>>(grid, ax, ay, dir, carrying, out, N, W, H);
  }
  return cudaGetLastError();
}

}  // namespace

// Whether view size V was instantiated.
extern "C" int obs_packed_supports_view(int V) { return V >= 3 && V <= 15 && V % 2 == 1; }

// out int32 [N, V, V] from grid int32 [N, W*H] and ax, ay, dir, carrying
// int32 [N], on `stream`; returns the launch's CUDA error (0 on success).
extern "C" int obs_packed_launch(const int* grid, const int* ax, const int* ay, const int* dir,
                                 const int* carrying, int* out, int N, int W, int H, int V, int see_through,
                                 void* stream) {
  if (N < 0 || W < 1 || H < 1 || !obs_packed_supports_view(V)) return (int)cudaErrorInvalidValue;
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
    default: return (int)launch_v<15>(grid, ax, ay, dir, carrying, out, N, W, H, st, s);
  }
}
