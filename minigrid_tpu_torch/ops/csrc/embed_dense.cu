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
// deterministic as the TPU kernel's sequential grid is.  Pass 1 is a
// product on the tensor cores (hopper.cuh): one CTA per (row tile of
// CELLS_PER_TILE view cells, 160 rows of dW1; chunk of CHUNK samples; slab
// of up to 256 hidden columns).  The last tile holds the direction's 4 rows
// and the db1 row, a row that every sample selects, as one more cell.  dy's
// rows arrive by TMA through a ring, the transposed one-hot tile is built in
// shared memory from packed/dir, and wgmma accumulates dW1^T in f32
// registers in sample order.  Each CTA writes its tile to a per-chunk
// partial; pass 2 adds the partials over the chunks in chunk order.  Two
// calls on the same inputs give the same bits.
//
// What bounds it on this card.  Forward: loads from L2 (W1 in bf16 is
// 504 KB at H = 256 and stays resident): 148 rows of 512 bytes per sample,
// against the one-hot product's 984 x 256 MACs per sample on the tensor
// cores.  The gather does 1/6.6 of the product's reads but runs on the
// load path, not the tensor cores.  Backward: the product is 1120 x H
// multiply-adds per sample at the tensor cores' rate (7 tiles of 160 rows
// at V = 7), and each of a chunk's 7 CTAs reads the chunk's dy rows, from
// L2 after the first: 7 x 2 H bytes per sample through an SM's share of the
// L2 bandwidth, about as long as the product.  At M = 131072 the 7 x 18
// CTAs are one wave on the 132 SMs.  The partials (a [985, H] f32 tile per
// chunk) are a write and a read of 4 bytes per row and column per chunk.
// A cluster multicasting each dy stage to a chunk's tiles would cut the L2
// traffic 7-fold.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "minigrid_env.cuh"

namespace {

using namespace minigrid;
using namespace hopper;

constexpr int PER_CELL = FEATURES_PER_CELL;  // 20
constexpr int FWD_THREADS = 256;
constexpr int KC = 64;             // samples per ring stage
constexpr int CHUNK = 114 * KC;    // samples per backward CTA: 18 chunks x 7 tiles at M = 131072, one wave
constexpr int CELLS_PER_TILE = 8;  // view cells per backward row tile
constexpr int TILE_N = CELLS_PER_TILE * PER_CELL;  // its rows: the wgmma N
constexpr int STAGES = 4;          // the dy ring

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

// Pass 1: one CTA per (row tile, chunk of CHUNK samples, slab of SLAB
// hidden columns), blockIdx.x the row tile, so that a chunk's tiles run
// together and its dy comes from L2.  Row tile t covers view cells
// CELLS_PER_TILE*t onwards, 20 rows each; the direction's 4 rows and the
// db1 row (a row every sample selects) form the last cell, V2.  The CTA
// computes dW1^T[slab, tile] = dy^T @ onehot on the tensor cores: the
// chunk's dy rows arrive by TMA through a ring of STAGES stages of KC
// samples, as one [KC, 64] box per warpgroup of a two-dimensional tensor map
// with the 128-byte swizzle (thread 0 refills a stage once every warp has
// read it), and each warpgroup takes its box's 64 hidden columns, their A
// fragments by ldmatrix.trans at the swizzled addresses (no bank
// conflicts), B = the stage's one-hot tile [KC, TILE_N], built in shared
// memory from packed/dir while the previous stage's wgmmas run.  No
// producer warp: the block stays a whole number of warpgroups, and so at
// 128 registers a thread.  Rows past M arrive as zeros; samples past the
// chunk select no row.  The f32 sums go to the chunk's partial rows.
constexpr int BOX = KC * 128;  // a [KC, 64] bf16 box of dy, 128-byte rows

template <int NWG>
struct BwdSmem {
  static constexpr int SLAB = 64 * NWG;
  static constexpr int STAGE = NWG * BOX;  // 1024-byte aligned boxes, as the swizzle asks
  static constexpr int BT = STAGES * STAGE;
  static constexpr int BT_BYTES = (KC / 16) * TILE_N * 32;
  static constexpr int MASK = BT + 2 * BT_BYTES;
  static constexpr int BARS = MASK + KC * CELLS_PER_TILE * 4;
  static constexpr int BYTES = BARS + STAGES * 8;
};

template <int NWG>
__global__ void __launch_bounds__(NWG * 128)
    embed_bwd_partial_kernel(const __grid_constant__ CUtensorMap dy_map, const int* __restrict__ packed,
                             const int* __restrict__ dir, float* __restrict__ part, int M, int V2, int H) {
  using L = BwdSmem<NWG>;
  constexpr int THREADS = NWG * 128;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint32_t* mask_s = reinterpret_cast<uint32_t*>(smem + L::MASK);  // [KC][CELLS_PER_TILE]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = blockIdx.x;
  const int chunk = blockIdx.y;
  const int h0 = blockIdx.z * L::SLAB;
  const int cell0 = tile * CELLS_PER_TILE;
  const int m0 = chunk * CHUNK;
  const int m1 = min(M, m0 + CHUNK);
  const int stages = (m1 - m0 + KC - 1) / KC;

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(&full[i], 1);
    fence_barrier_init();
  }
  __syncthreads();

  // Thread 0 brings stage i's dy rows into its slot, a box per warpgroup
  // (rows past M arrive as zeros; the byte count is the boxes' whole).
  auto load_stage = [&](int i) {
    const int st = i % STAGES;
    fence_proxy_async();  // after the block's reads of the slot's last stage
    mbar_arrive_expect_tx(&full[st], L::STAGE);
    for (int b = 0; b < NWG; ++b) {
      tma_load_2d(smem + st * L::STAGE + b * BOX, &dy_map, h0 + 64 * b, m0 + i * KC, &full[st]);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < STAGES && i < stages; ++i) load_stage(i);
  }

  // The packed cells (or the direction) of stage i that this thread turns
  // into feature bits, read a stage ahead so that the loads' latency
  // overlaps a stage's products: -1 past M or past the last cell, a
  // direction outside [0, 4) as 4.
  constexpr int Q = (KC * CELLS_PER_TILE + THREADS - 1) / THREADS;
  auto load_raw = [&](int i, int (&raw)[Q]) {
    const int base = m0 + i * KC;
#pragma unroll
    for (int u = 0; u < Q; ++u) {
      const int q = tid + u * THREADS;
      const int m = base + q / CELLS_PER_TILE;
      const int cell = cell0 + q % CELLS_PER_TILE;
      int v = -1;
      if (q < KC * CELLS_PER_TILE && m < m1 && cell <= V2) {
        if (cell < V2) {
          v = packed[(size_t)m * V2 + cell];
        } else {
          const int d = dir[m];
          v = d >= 0 && d < 4 ? d : 4;
        }
      }
      raw[u] = v;
    }
  };

  // Builds stage i's one-hot tile in buffer `buf`: the rows each sample
  // selects in the tile's cells as bits, then B [KC, TILE_N] in the B layout
  // of hopper.cuh, 8 samples (16 bytes) per thread and store.
  auto build = [&](int i, int buf, const int (&raw)[Q]) {
#pragma unroll
    for (int u = 0; u < Q; ++u) {
      const int q = tid + u * THREADS;
      if (q < KC * CELLS_PER_TILE) {
        const int cell = cell0 + q % CELLS_PER_TILE;
        const int v = raw[u];
        mask_s[q] = v < 0 ? 0u : cell < V2 ? cell_bits(v) : (v < 4 ? 1u << v : 0u) | (1u << 4);
      }
    }
    __syncthreads();
    // Every warp has read stage i - 1's rows (before this build): refill.
    if (tid == 0 && i >= 1 && i - 1 + STAGES < stages) load_stage(i - 1 + STAGES);
    unsigned char* bt = smem + L::BT + buf * L::BT_BYTES;
    for (int q = tid; q < (KC / 8) * TILE_N; q += THREADS) {
      const int f = q % TILE_N;
      const int k8 = q / TILE_N;  // 8 samples: K tile k8 / 2, half k8 % 2
      const int cc = f / PER_CELL, r = f % PER_CELL;
      const uint32_t* mk = mask_s + (k8 * 8) * CELLS_PER_TILE + cc;
      uint32_t v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint32_t b0 = (mk[(2 * u) * CELLS_PER_TILE] >> r) & 1u;
        const uint32_t b1 = (mk[(2 * u + 1) * CELLS_PER_TILE] >> r) & 1u;
        v[u] = onehot_pair(b0 | b1 << 1);
      }
      const int off = (k8 >> 1) * TILE_N * 32 + ((f >> 3) * 2 + (k8 & 1)) * 128 + (f & 7) * 16;
      *reinterpret_cast<uint4*>(bt + off) = make_uint4(v[0], v[1], v[2], v[3]);
    }
    fence_proxy_async();
    __syncthreads();
  };

  const int wg = tid >> 7;           // the warpgroup: hidden columns 64 wg onwards of the slab
  const int wl = (tid >> 5) & 3;     // the warp within it: 16 of them
  const int c = lane & 3;
  float acc[TILE_N / 2];
#pragma unroll
  for (int i = 0; i < TILE_N / 2; ++i) acc[i] = 0.f;
  int raw[Q];
  load_raw(0, raw);
  build(0, 0, raw);
  if (stages > 1) load_raw(1, raw);
  for (int i = 0; i < stages; ++i) {
    const int st = i % STAGES;
    mbar_wait(&full[st], (i / STAGES) & 1);
    const unsigned char* box = smem + st * L::STAGE + wg * BOX;
    uint32_t af[KC / 16][4];
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      // Row srow's 16-byte chunk ch sits at chunk ch ^ (srow % 8) of the
      // 128-byte row (the 128-byte swizzle).
      const int q = lane >> 3;
      const int srow = kk * 16 + (lane & 7) + 8 * (q >> 1);
      const int ch = 2 * wl + (q & 1);
      ldmatrix_x4_trans(af[kk], box + srow * 128 + ((ch ^ (srow & 7)) << 4));
    }
    const unsigned char* bt = smem + L::BT + (i & 1) * L::BT_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) wgmma_m64n160k16_rs(acc, af[kk], b_desc(bt + kk * TILE_N * 32));
    wgmma_commit();
    if (i + 1 < stages) {
      build(i + 1, (i + 1) & 1, raw);
      if (i + 2 < stages) load_raw(i + 2, raw);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk)
#pragma unroll
      for (int u = 0; u < 4; ++u) fence_operand(af[kk][u]);
#pragma unroll
    for (int u = 0; u < TILE_N / 2; ++u) fence_operand(acc[u]);
  }

  const int total_rows = V2 * PER_CELL + 5;
  const int h = h0 + 64 * wg + 16 * wl + (lane >> 2);
  float* dst = part + (size_t)chunk * total_rows * H;
#pragma unroll
  for (int j = 0; j < TILE_N / 8; ++j) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int f = tile * TILE_N + 8 * j + 2 * c + u;
      if (f < total_rows) {
        dst[(size_t)f * H + h] = acc[4 * j + u];
        dst[(size_t)f * H + h + 8] = acc[4 * j + 2 + u];
      }
    }
  }
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

// Hidden sizes of the forward: 4 hidden units per thread, 256 threads per
// block in whole samples.
bool hidden_ok(int H) { return H >= 4 && H <= 512 && H % 4 == 0 && FWD_THREADS % (H / 4) == 0; }

// Hidden sizes of the backward: whole slabs of 64 columns per warpgroup
// (a narrower dy comes padded to 64 columns).
bool bwd_hidden_ok(int H) { return H == 64 || H == 128 || H == 256 || H == 512; }

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// dy [M, H] bf16 as a tensor map of [KC, 64] boxes with the 128-byte
// swizzle, rows past M filled with zeros; false if the driver refuses.  The
// encoder is a driver call: it needs the device's context current on the
// calling thread, which a thread of PyTorch's autograd engine may not have
// until its first runtime call, so the current device is set first.
bool dy_tensor_map(CUtensorMap* map, const void* dy, int M, int H) {
  static EncodeTiled encode = nullptr;
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || cudaSetDevice(device) != cudaSuccess) return false;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return false;
    }
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)H, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)H * 2};
  const cuuint32_t box[2] = {64, KC};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(dy), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NWG>
cudaError_t launch_bwd_partial(dim3 grid, const CUtensorMap& dy_map, const int* packed, const int* dir, float* part,
                               int M, int V2, int H, cudaStream_t s) {
  constexpr int bytes = BwdSmem<NWG>::BYTES;
  const cudaError_t err = cudaFuncSetAttribute(embed_bwd_partial_kernel<NWG>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  embed_bwd_partial_kernel<NWG><<<grid, NWG * 128, bytes, s>>>(dy_map, packed, dir, part, M, V2, H);
  return cudaGetLastError();
}

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

// Dynamic shared memory (bytes) of the backward's pass 1 at hidden size H.
extern "C" int embed_dense1_bwd_smem_bytes(int H) {
  if (!bwd_hidden_ok(H)) return 0;
  const int nwg = min(H / 64, 4);
  return nwg == 1 ? BwdSmem<1>::BYTES : nwg == 2 ? BwdSmem<2>::BYTES : BwdSmem<4>::BYTES;
}

// Number of chunks, so the caller can size `part` as [chunks, V2*20+5, H] f32.
extern "C" int embed_dense1_bwd_chunks(int M) { return (M + CHUNK - 1) / CHUNK; }

// f32 dw1 [V2*20+4, H] and db1 [H] from bf16 dy [M, H], H one of 64, 128,
// 256, 512; `part` is scratch.
extern "C" int embed_dense1_bwd_launch(const int* packed, const int* dir, const void* dy,
                                       float* part, float* dw1, float* db1, int M, int V2, int H,
                                       void* stream) {
  if (M < 1 || V2 < 1 || !bwd_hidden_ok(H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = (M + CHUNK - 1) / CHUNK;
  const int nwg = min(H / 64, 4);
  const dim3 grid1((V2 + 1 + CELLS_PER_TILE - 1) / CELLS_PER_TILE, chunks, H / (64 * nwg));
  CUtensorMap dy_map;
  if (!dy_tensor_map(&dy_map, dy, M, H)) return (int)cudaErrorNotSupported;
  cudaError_t err = nwg == 1   ? launch_bwd_partial<1>(grid1, dy_map, packed, dir, part, M, V2, H, s)
                    : nwg == 2 ? launch_bwd_partial<2>(grid1, dy_map, packed, dir, part, M, V2, H, s)
                               : launch_bwd_partial<4>(grid1, dy_map, packed, dir, part, M, V2, H, s);
  if (err != cudaSuccess) return (int)err;
  const size_t elems = (size_t)(V2 * PER_CELL + 5) * H;
  const int threads = 256;
  embed_bwd_reduce_kernel<<<(unsigned)((elems + threads - 1) / threads), threads, 0, s>>>(
      part, dw1, db1, chunks, V2, H);
  return (int)cudaGetLastError();
}
