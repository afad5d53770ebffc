// Fused one-hot embedding + first dense layer for Hopper (sm_90a), forward
// and backward.
//
// Replaces the Pallas TPU kernels minigrid_tpu/ops/embed_dense.py::_fwd_kernel
// and ::_bwd_kernel.  The features of a sample are the one-hots of its V*V
// packed view cells (per cell 11 type + 6 color + 3 state rows, state
// clipped to [0, 2]) and of its direction (4 rows): F = V*V*20 + 4 rows of
// W1 [F, H].  A field outside its range selects no row, as the one-hot
// comparison does.
//
// Forward: out[m] = bf16(bf16(onehot(m) @ bf16(W1)) + bf16(b1)).  One-hot @ W1
// is a gather-sum: the f32 sum of the 3*V*V + 1 rows of W1 the sample
// selects (148 for V = 7), so the one-hot matrix exists nowhere.  A group of
// H/4 threads owns a sample, each thread 4 hidden units read as one 8-byte
// load, so a group reads whole 2*H-byte rows, coalesced.  Rounding follows
// the TPU kernel (embed_dense.py:112): the sum is rounded to bf16 first,
// then bf16(b1) is added and the result rounded again.
//
// Backward: dW1 = onehot^T @ dy and db1 = sum_m dy, accumulated in f32, and
// deterministic as the TPU kernel's sequential grid is.  Pass 1 runs one CTA
// per (view cell or the direction slot, chunk of CHUNK samples); thread h
// owns hidden column h of a [20, H] f32 tile in shared memory and adds
// dy[m, h] into the rows sample m selects, in sample order: no two threads
// touch one address, so no atomics.  The direction CTA also sums db1.  Each
// CTA writes its tile to a per-chunk partial; pass 2 adds the partials over
// the chunks in chunk order.  Two calls on the same inputs give the same
// bits.
//
// What bounds it on this card.  Forward: loads from L2 (W1 in bf16 is
// 504 KB at H = 256 and stays resident): 148 rows of 512 bytes per sample,
// against the one-hot product's 984 x 256 MACs per sample on the tensor
// cores.  The gather does 1/6.6 of the product's reads but runs on the
// load path, not the tensor cores.  Backward: each of the 50 CTAs of a chunk
// reads the chunk's dy rows (L2 hits after the first), and the three
// shared-memory read-modify-writes per (sample, cell, column) bound the
// pass.  A later change could keep a chunk of dy in shared memory for
// several cells, or use the tensor cores on one-hot tiles built in shared
// memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "minigrid_env.cuh"

namespace {

using namespace minigrid;

constexpr int PER_CELL = FEATURES_PER_CELL;  // 20
constexpr int FWD_THREADS = 256;
constexpr int CHUNK = 4096;  // samples per backward CTA

__device__ __forceinline__ float bf(const __nv_bfloat16 x) { return __bfloat162float(x); }

// Adds 4 bf16 values at `row` (8-byte aligned) into acc.
__device__ __forceinline__ void add_row4(float acc[4], const __nv_bfloat16* row) {
  const uint2 raw = *reinterpret_cast<const uint2*>(row);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  acc[0] += __low2float(lo);
  acc[1] += __high2float(lo);
  acc[2] += __low2float(hi);
  acc[3] += __high2float(hi);
}

__global__ void __launch_bounds__(FWD_THREADS)
    embed_fwd_kernel(const int* __restrict__ packed, const int* __restrict__ dir,
                     const __nv_bfloat16* __restrict__ w1, const __nv_bfloat16* __restrict__ b1,
                     __nv_bfloat16* __restrict__ out, int M, int V2, int H) {
  const int tps = H / 4;  // threads per sample
  const int spb = FWD_THREADS / tps;
  const int g = threadIdx.x / tps;
  const int h0 = 4 * (threadIdx.x % tps);
  for (int m = blockIdx.x * spb + g; m < M; m += gridDim.x * spb) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const int* pk = packed + (size_t)m * V2;
    for (int slot = 0; slot < V2; ++slot) {
      const CellRows r = cell_rows(pk[slot], slot);
      if (r.type >= 0) add_row4(acc, w1 + (size_t)r.type * H + h0);
      if (r.color >= 0) add_row4(acc, w1 + (size_t)r.color * H + h0);
      add_row4(acc, w1 + (size_t)r.state * H + h0);
    }
    const int d = direction_row(dir[m], V2);
    if (d >= 0) add_row4(acc, w1 + (size_t)d * H + h0);
    float o[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) o[u] = bf(__float2bfloat16_rn(acc[u])) + bf(b1[h0 + u]);
    const __nv_bfloat162 lo = __floats2bfloat162_rn(o[0], o[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(o[2], o[3]);
    uint2 raw;
    raw.x = *reinterpret_cast<const uint32_t*>(&lo);
    raw.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(out + (size_t)m * H + h0) = raw;
  }
}

// Pass 1: blockIdx.x = view cell (V2 = the direction slot), blockIdx.y =
// chunk.  Partial rows per chunk: V2*20 cell rows, 4 direction rows, 1 db1
// row.  Dynamic shared memory: [20, H] f32.
__global__ void embed_bwd_partial_kernel(const int* __restrict__ packed,
                                         const int* __restrict__ dir,
                                         const __nv_bfloat16* __restrict__ dy,
                                         float* __restrict__ part, int M, int V2, int H) {
  extern __shared__ float tile[];
  const int slot = blockIdx.x;
  const int chunk = blockIdx.y;
  const int h = threadIdx.x;
  const int rows = slot < V2 ? PER_CELL : 5;
  for (int r = 0; r < rows; ++r) tile[r * H + h] = 0.f;
  const int m0 = chunk * CHUNK;
  const int m1 = min(M, m0 + CHUNK);
  if (slot < V2) {
    for (int m = m0; m < m1; ++m) {
      // Rows of this cell's tile: the cell's feature rows, taken as slot 0.
      const CellRows r = cell_rows(packed[(size_t)m * V2 + slot], 0);
      const float g = bf(dy[(size_t)m * H + h]);
      if (r.type >= 0) tile[r.type * H + h] += g;
      if (r.color >= 0) tile[r.color * H + h] += g;
      tile[r.state * H + h] += g;
    }
  } else {
    for (int m = m0; m < m1; ++m) {
      const int d = direction_row(dir[m], 0);
      const float g = bf(dy[(size_t)m * H + h]);
      if (d >= 0) tile[d * H + h] += g;
      tile[4 * H + h] += g;
    }
  }
  const int total_rows = V2 * PER_CELL + 5;
  float* dst = part + ((size_t)chunk * total_rows + (size_t)slot * PER_CELL) * H + h;
  for (int r = 0; r < rows; ++r) dst[(size_t)r * H] = tile[r * H + h];
}

// Pass 2: element (row, h) of dW1 [V2*20+4, H] (and db1 as the last row) is
// the sum of its partials over the chunks, in chunk order.
__global__ void embed_bwd_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw1,
                                        float* __restrict__ db1, int chunks, int V2, int H) {
  const int total_rows = V2 * PER_CELL + 5;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)total_rows * H) return;
  float sum = 0.f;
  for (int c = 0; c < chunks; ++c) sum += part[(size_t)c * total_rows * H + idx];
  const size_t dw_elems = (size_t)(total_rows - 1) * H;
  if (idx < dw_elems) {
    dw1[idx] = sum;
  } else {
    db1[idx - dw_elems] = sum;
  }
}

// The backward tile [20, H] f32 stays within the 48 KB of shared memory a
// launch may use without opting in.
bool hidden_ok(int H) { return H >= 4 && H <= 512 && H % 4 == 0 && FWD_THREADS % (H / 4) == 0; }

}  // namespace

// bf16 out [M, H] from packed [M, V2], dir [M], bf16 w1 [V2*20+4, H], bf16 b1 [H].
extern "C" int embed_dense1_fwd_launch(const int* packed, const int* dir, const void* w1,
                                       const void* b1, void* out, int M, int V2, int H,
                                       void* stream) {
  if (M < 0 || V2 < 1 || !hidden_ok(H)) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  const int spb = FWD_THREADS / (H / 4);
  const int blocks = min((M + spb - 1) / spb, 132 * 16);
  embed_fwd_kernel<<<blocks, FWD_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      packed, dir, static_cast<const __nv_bfloat16*>(w1), static_cast<const __nv_bfloat16*>(b1),
      static_cast<__nv_bfloat16*>(out), M, V2, H);
  return (int)cudaGetLastError();
}

// Number of chunks, so the caller can size `part` as [chunks, V2*20+5, H] f32.
extern "C" int embed_dense1_bwd_chunks(int M) { return (M + CHUNK - 1) / CHUNK; }

// f32 dw1 [V2*20+4, H] and db1 [H] from bf16 dy [M, H]; `part` is scratch.
extern "C" int embed_dense1_bwd_launch(const int* packed, const int* dir, const void* dy,
                                       float* part, float* dw1, float* db1, int M, int V2, int H,
                                       void* stream) {
  if (M < 1 || V2 < 1 || !hidden_ok(H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = (M + CHUNK - 1) / CHUNK;
  const dim3 grid1(V2 + 1, chunks);
  embed_bwd_partial_kernel<<<grid1, H, PER_CELL * H * sizeof(float), s>>>(
      packed, dir, static_cast<const __nv_bfloat16*>(dy), part, M, V2, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t elems = (size_t)(V2 * PER_CELL + 5) * H;
  const int threads = 256;
  embed_bwd_reduce_kernel<<<(unsigned)((elems + threads - 1) / threads), threads, 0, s>>>(
      part, dw1, db1, chunks, V2, H);
  return (int)cudaGetLastError();
}
