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
// Forward: out[m] = bf16(bf16(onehot(m) @ bf16(W1)) + bf16(b1)), the
// one-hot product on the tensor cores, as the TPU kernel runs it on the MXU
// (embed_dense.py:103-112).  A first kernel turns each sample's cells into
// its one-hot words (32 feature rows a word), once.  In the second, each
// CTA holds a slab of 64 hidden columns of bf16(W1) (992 rows at V = 7,
// 127 KB; narrower slabs for larger views, a narrower H padded with zero
// columns) resident in shared memory for the whole call, cast from f32 as
// it loads; 33 CTAs a slab at H = 256 cover the 132 SMs.  Each of a CTA's
// four warpgroups walks its own 64-sample M tiles: the tile's words arrive
// by cp.async while the previous tile's products run; the A fragments
// (bf16 0/1) come from the words in registers, a shift, two prmt and two
// ands a row and K tile, because the slab's K order puts each lane's bits
// at the top of a byte (fwd_row); wgmma m64nNSk16 accumulates in f32 over
// the K tiles in order, so two calls give the same bits.  The epilogue
// rounds as the TPU kernel does (the sum to bf16, then + bf16(b1), rounded
// again) into shared memory, and the tile's rows leave as 16-byte stores.
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
// What bounds it on this card.  Forward: the operations of the padded
// product, 992 x 256 multiply-adds per sample (66.6 GFLOP at M = 131072,
// 0.067 ms on the tensor cores), and the bytes it must move (26 MB of
// packed cells in, 67 MB out, 0.028 ms).  The tensor cores run
// m64n64k16 at their full rate, but the warps that issue the wgmmas also
// build the A fragments (~12 instructions a K tile per thread) and pass
// the warpgroup's fence, commit and wait: on the H100 (700 W) the builds
// and the wgmmas alone take about as long, and four warpgroups a SM overlap
// them only in part, so the call runs at ~3x the tensor cores' floor
// (tools/embed_forward_split.py).  The words kernel reads the packed cells
// once (the second kernel reads 16 MB of words once per slab, from L2).
// Backward: the product is 1120 x H multiply-adds per sample at the tensor
// cores' rate (7 tiles of 160 rows at V = 7), and each of a chunk's 7 CTAs
// reads the chunk's dy rows, from L2 after the first: 7 x 2 H bytes per
// sample through an SM's share of the L2 bandwidth, about as long as the
// product.  At M = 131072 the 7 x 18 CTAs are one wave on the 132 SMs.
// The partials (a [985, H] f32 tile per chunk) are a write and a read of 4
// bytes per row and column per chunk.  A cluster multicasting each dy
// stage to a chunk's tiles would cut the L2 traffic 7-fold.

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
constexpr int KC = 64;             // samples per ring stage
constexpr int CHUNK = 114 * KC;    // samples per backward CTA: 18 chunks x 7 tiles at M = 131072, one wave
constexpr int CELLS_PER_TILE = 8;  // view cells per backward row tile
constexpr int TILE_N = CELLS_PER_TILE * PER_CELL;  // its rows: the wgmma N
constexpr int STAGES = 4;          // the dy ring

__device__ __forceinline__ float bf(const __nv_bfloat16 x) { return __bfloat162float(x); }

// The forward, in two kernels.  The first turns each sample's packed cells
// and direction into its one-hot words (feature row f is bit f % 32 of word
// f / 32), once, into a scratch [M, words].  In the second, a CTA holds one
// slab of NS hidden columns of bf16(W1) (blockIdx.y) in shared memory for
// the whole call and has up to FWD_MAX_WG consumer warpgroups, each walking
// its own M tiles of 64 samples (a stride of gridDim.x * warpgroups tiles).
constexpr int FWD_MAX_WG = 4;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may opt into
constexpr int FWD_TILE = 64;        // samples per M tile: one wgmma M
constexpr int WORDS_THREADS = 256;  // threads of a words block
constexpr int WORDS_ROWS = 8;       // samples per warp of the words kernel

__host__ __device__ constexpr int fwd_words(int V2) { return (V2 * PER_CELL + 4 + 31) / 32; }
// Words in the products: an even number, W1's rows padded with zeros to
// 64 of them a pair of words.
__host__ __device__ constexpr int fwd_words_even(int V2) { return (fwd_words(V2) + 1) & ~1; }
// A tile's row of words in shared memory: at least the words, 2 mod 4.
__host__ __device__ constexpr int fwd_row_stride(int V2) { return fwd_words(V2) + ((2 - fwd_words(V2)) & 3); }

// The second kernel's dynamic shared memory, in bytes from the base: the
// slab (2 * words_even K tiles of NS x 16 bf16 in the B layout), bf16(b1)
// of the slab's columns as floats, then per warpgroup two buffers, one for
// the tile in the products and one for the next tile's words, arriving.  A
// buffer holds first a tile's words ([64][ws], ws = 2 mod 4, so that the 8
// rows whose word pairs a warp's lanes read as 8 bytes fall in distinct
// banks) and then its bf16 output ([64] rows of 2 * NS + 16 bytes: the
// epilogue's lanes write distinct banks).
struct FwdLayout {
  int words, pairs, ws, bias, wg0, stage_row, buf;
  __host__ __device__ FwdLayout(int V2, int NS)
      : words(fwd_words(V2)),
        pairs(fwd_words_even(V2) / 2),
        ws(fwd_row_stride(V2)),
        bias(64 * fwd_words_even(V2) * NS),
        wg0(64 * fwd_words_even(V2) * NS + NS * 4),
        stage_row(2 * NS + 16),
        buf((max(FWD_TILE * fwd_row_stride(V2) * 4, FWD_TILE * (2 * NS + 16)) + 15) / 16 * 16) {}
  __host__ __device__ int bytes(int nwg) const { return wg0 + nwg * 2 * buf; }
};

// The one-hot words, a warp per WORDS_ROWS samples: their packed cells,
// read coalesced, 8 loads in flight a lane, turned into the feature bits
// each selects (cell_bits; the direction as one more cell of 4 rows, none
// outside [0, 4)) in shared memory, then a lane per word, the OR of the
// cells whose 20 rows overlap it, written out coalesced.
__global__ void __launch_bounds__(WORDS_THREADS)
    embed_fwd_words_kernel(const int* __restrict__ packed, const int* __restrict__ dir,
                           uint32_t* __restrict__ words, int M, int V2) {
  extern __shared__ uint32_t cb[];  // [warps][WORDS_ROWS][V2 + 1]
  const int lane = threadIdx.x & 31;
  const int m0 = (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * WORDS_ROWS;
  if (m0 >= M) return;
  const int rows = min(WORDS_ROWS, M - m0);
  const int cells = V2 + 1;
  uint32_t* tile = cb + (threadIdx.x >> 5) * WORDS_ROWS * cells;
  const int* pk = packed + (size_t)m0 * V2;
  for (int s0 = 0; s0 < V2; s0 += 32) {
    const int s = s0 + lane;
    int v[WORDS_ROWS];
#pragma unroll
    for (int r = 0; r < WORDS_ROWS; ++r) v[r] = s < V2 && r < rows ? pk[r * V2 + s] : 0;
#pragma unroll
    for (int r = 0; r < WORDS_ROWS; ++r) {
      if (s < V2) tile[r * cells + s] = cell_bits(v[r]);
    }
  }
  if (lane < rows) {
    const int d = dir[m0 + lane];
    tile[lane * cells + V2] = d >= 0 && d < 4 ? 1u << d : 0u;
  }
  __syncwarp();
  const int nw = fwd_words(V2);
  for (int r = 0; r < rows; ++r) {
    const uint32_t* row = tile + r * cells;
    for (int w = lane; w < nw; w += 32) {
      const int s1 = min((32 * w + 31) / PER_CELL, V2);
      uint32_t word = 0;
      for (int s = (32 * w) / PER_CELL; s <= s1; ++s) {
        const int sh = PER_CELL * s - 32 * w;
        word |= sh >= 0 ? row[s] << sh : row[s] >> -sh;
      }
      words[(size_t)(m0 + r) * nw + w] = word;
    }
  }
}

// D[64, NS] += A[64, 16] x B[16, NS].
template <int NS>
__device__ __forceinline__ void fwd_mma(float (&d)[NS / 2], const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (NS == 64) {
    wgmma_m64n64k16_rs(d, a, desc);
  } else if constexpr (NS == 32) {
    wgmma_m64n32k16_rs(d, a, desc);
  } else if constexpr (NS == 16) {
    wgmma_m64n16k16_rs(d, a, desc);
  } else {
    wgmma_m64n8k16_rs(d, a, desc);
  }
}

// The K order of the slab.  Lane l of a warp (c = l % 4) needs, for K
// tile 2w + p of a row, the one-hot bits of K columns 8h + 2c + e (h, e
// in {0, 1}) as the bf16 pairs a[h] (e = 0 in the low half).  The slab's K
// column 8h + 2c + e of tile 2w + p holds W1's row 32w + i with
// i = 8 * (2h + e) + 7 - c - 4p, so that after the word is shifted left by
// c + 4p those bits are the top bits of its bytes 2h + e, which prmt
// spreads into the pair (onehot_sign_pair): one shift, two prmt and two
// ands give a row's two fragment registers.  The sum over K is the same
// in any order.
__device__ __forceinline__ int fwd_row(int kt, int kk) {
  const int p = kt & 1, h = kk >> 3, c = (kk >> 1) & 3, e = kk & 1;
  return 32 * (kt >> 1) + 8 * (2 * h + e) + 7 - c - 4 * p;
}

template <int NS>
__global__ void __launch_bounds__(FWD_MAX_WG * 128)
    embed_fwd_kernel(const uint32_t* __restrict__ words, const float* __restrict__ w1, const float* __restrict__ b1,
                     __nv_bfloat16* __restrict__ out, int M, int V2, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdLayout L(V2, NS);
  const int tid = threadIdx.x;
  const int nwg = blockDim.x >> 7;
  const int h0 = blockIdx.y * NS;
  const int vc = min(NS, H - h0);  // the slab's columns inside H (H < NS: the rest are zeros)
  const int F = V2 * PER_CELL + 4;
  float* bias_s = reinterpret_cast<float*>(smem + L.bias);

  // The slab: per thread and step 8 K columns of 4 hidden columns, from 8
  // rows of W1 read 16 bytes a lane (coalesced across the warp), stored as
  // 16 bytes (8 K columns) per hidden column.
  for (int u = tid; u < 2 * L.pairs * NS; u += blockDim.x) {
    const int n = 4 * (u % (NS / 4));
    const int g8 = u / (NS / 4);  // K tile g8 / 2, half g8 % 2
    const int kt = g8 >> 1, h = g8 & 1;
    float4 x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int f = fwd_row(kt, 8 * h + j);
      x[j] = f < F && n < vc ? *reinterpret_cast<const float4*>(w1 + (size_t)f * H + h0 + n)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    unsigned char* dst = smem + kt * NS * 32 + ((n >> 3) * 2 + h) * 128 + (n & 7) * 16;
    *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16(x[0].x, x[1].x), pack_bf16(x[2].x, x[3].x),
                                                pack_bf16(x[4].x, x[5].x), pack_bf16(x[6].x, x[7].x));
    *reinterpret_cast<uint4*>(dst + 16) = make_uint4(pack_bf16(x[0].y, x[1].y), pack_bf16(x[2].y, x[3].y),
                                                     pack_bf16(x[4].y, x[5].y), pack_bf16(x[6].y, x[7].y));
    *reinterpret_cast<uint4*>(dst + 32) = make_uint4(pack_bf16(x[0].z, x[1].z), pack_bf16(x[2].z, x[3].z),
                                                     pack_bf16(x[4].z, x[5].z), pack_bf16(x[6].z, x[7].z));
    *reinterpret_cast<uint4*>(dst + 48) = make_uint4(pack_bf16(x[0].w, x[1].w), pack_bf16(x[2].w, x[3].w),
                                                     pack_bf16(x[4].w, x[5].w), pack_bf16(x[6].w, x[7].w));
  }
  for (int n = tid; n < NS; n += blockDim.x) bias_s[n] = n < vc ? bf(__float2bfloat16_rn(b1[h0 + n])) : 0.f;
  fence_proxy_async();  // the slab, written by the generic proxy, is read by wgmma
  __syncthreads();

  const int wg = tid >> 7;
  const int wt = tid & 127;
  const int lane = tid & 31;
  const int wl = wt >> 5;  // the warp within its warpgroup: rows 16 wl..16 wl + 15 of a tile
  const int c = lane & 3;
  const int bar = 1 + wg;
  unsigned char* bufs = smem + L.wg0 + wg * 2 * L.buf;
  const int tiles = (M + FWD_TILE - 1) / FWD_TILE;
  const int stride = gridDim.x * nwg;

  // Tile t's words into buffer `b`, copied asynchronously while the
  // previous tile's products run, a warp per row; a row past M and the pad
  // word of an odd count are zeros.
  auto fetch = [&](int t, int b) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(bufs + b * L.buf);
    const int m0 = t * FWD_TILE;
    for (int r = wl; r < FWD_TILE; r += 4) {
      for (int w = lane; w < 2 * L.pairs; w += 32) {
        if (m0 + r < M && w < L.words) {
          cp_async4(dst + r * L.ws + w, words + (size_t)(m0 + r) * L.words + w);
        } else {
          dst[r * L.ws + w] = 0u;
        }
      }
    }
  };

  int t = blockIdx.x * nwg + wg;
  int b = 0;
  if (t < tiles) fetch(t, 0);
  for (; t < tiles; t += stride, b ^= 1) {
    const int m0 = t * FWD_TILE;
    const int rows = min(FWD_TILE, M - m0);
    cp_async_wait_all();
    named_sync(bar, 128);  // tile t's words are in; every thread is done with the other buffer
    if (t + stride < tiles) fetch(t + stride, b ^ 1);
    unsigned char* buf = bufs + b * L.buf;

    // The product: a group of two words (four K tiles) per wgmma fence,
    // commit and wait, which synchronise the warpgroup; the A fragments of
    // group g + 2 built while groups g - 1, g and g + 1 run (four register
    // sets).
    float acc[NS / 2];
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) acc[i] = 0.f;
    const uint2* wr0 = reinterpret_cast<const uint2*>(buf + (16 * wl + (lane >> 2)) * L.ws * 4);
    const uint2* wr8 = wr0 + 8 * L.ws / 2;
    uint32_t fa[4][4], fb[4][4], fc[4][4] = {}, fd[4][4] = {};
    auto build = [&](int g, uint32_t(&fr)[4][4]) {
      const uint2 x0 = wr0[g], x1 = wr8[g];
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // K tile 4g + k: word 2g + k / 2, p = k % 2
        const int sh = c + 4 * (k & 1);
        const uint32_t a0 = (k < 2 ? x0.x : x0.y) << sh, a1 = (k < 2 ? x1.x : x1.y) << sh;
        fr[k][0] = onehot_sign_pair<0>(a0);
        fr[k][1] = onehot_sign_pair<0>(a1);
        fr[k][2] = onehot_sign_pair<2>(a0);
        fr[k][3] = onehot_sign_pair<2>(a1);
      }
    };
    const uint64_t desc0 = b_desc(smem);
    // Issues group g's four products from `cur`; once group g - 2 is done,
    // builds group g + 2 into its registers, `nxt`.
    auto step = [&](int g, const uint32_t(&cur)[4][4], uint32_t(&nxt)[4][4]) {
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) fwd_mma<NS>(acc, cur[k], desc0 + (uint64_t)((4 * g + k) * NS * 2));
      wgmma_commit();
      wgmma_wait<2>();
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i) fence_operand(nxt[k][i]);
      if (g + 2 < L.pairs) build(g + 2, nxt);
    };
    build(0, fa);
    if (L.pairs > 1) build(1, fb);
    for (int g = 0; g < L.pairs; g += 4) {
      step(g, fa, fc);
      if (g + 1 < L.pairs) step(g + 1, fb, fd);
      if (g + 2 < L.pairs) step(g + 2, fc, fa);
      if (g + 3 < L.pairs) step(g + 3, fd, fb);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        fence_operand(fa[k][i]);
        fence_operand(fb[k][i]);
        fence_operand(fc[k][i]);
        fence_operand(fd[k][i]);
      }
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) fence_operand(acc[i]);
    named_sync(bar, 128);  // every warp is done with the words

    // Epilogue: bf16(bf16(sum) + bf16(b1)) into the output rows (over the
    // words), then the tile's rows out, 16 bytes (8 columns) a store, rows
    // past M dropped.
    {
      const int r0 = 16 * wl + (lane >> 2);
      uint32_t* st32 = reinterpret_cast<uint32_t*>(buf);
      const int sw = L.stage_row / 4;
#pragma unroll
      for (int j = 0; j < NS / 8; ++j) {
        const int col = 8 * j + 2 * c;
        const float bx = bias_s[col], by = bias_s[col + 1];
        st32[r0 * sw + col / 2] =
            pack_bf16(bf(__float2bfloat16_rn(acc[4 * j])) + bx, bf(__float2bfloat16_rn(acc[4 * j + 1])) + by);
        st32[(r0 + 8) * sw + col / 2] =
            pack_bf16(bf(__float2bfloat16_rn(acc[4 * j + 2])) + bx, bf(__float2bfloat16_rn(acc[4 * j + 3])) + by);
      }
    }
    named_sync(bar, 128);
    if (vc % 8 == 0) {
      const int upr = vc / 8;  // 16-byte units per row
      for (int q = wt; q < rows * upr; q += 128) {
        const int r = q / upr, u = q % upr;
        *reinterpret_cast<uint4*>(out + (size_t)(m0 + r) * H + h0 + 8 * u) =
            *reinterpret_cast<const uint4*>(buf + r * L.stage_row + 16 * u);
      }
    } else {  // H = 4: one 8-byte store per row
      for (int r = wt; r < rows; r += 128) {
        *reinterpret_cast<uint2*>(out + (size_t)(m0 + r) * H) = *reinterpret_cast<const uint2*>(buf + r * L.stage_row);
      }
    }
  }
}

// The forward for views whose slab does not fit shared memory beside two
// warpgroups at any width (v >= 17 at V2 = v*v): the same product, with the slab streamed through
// shared memory in chunks of FWD_STREAM_WORDS words (64 K rows a word) in
// its K order.  A CTA's warpgroups take one M tile each, keep its
// accumulators in registers across the chunks, and for each chunk load the
// chunk's slab together (a barrier before and after) and each its tile's
// words; then they issue the chunk's word pairs as the resident kernel
// does, in the same order, so two calls give the same bits.  The slab is
// read once per group of the CTA's tiles, from L2.
constexpr int FWD_STREAM_WORDS = 32;

struct FwdStreamLayout {
  int ws, bias, wg0, stage_row, buf;
  __host__ __device__ FwdStreamLayout(int NS)
      : ws(FWD_STREAM_WORDS + 2),
        bias(64 * FWD_STREAM_WORDS * NS),
        wg0(64 * FWD_STREAM_WORDS * NS + NS * 4),
        stage_row(2 * NS + 16),
        buf((max(FWD_TILE * (FWD_STREAM_WORDS + 2) * 4, FWD_TILE * (2 * NS + 16)) + 15) / 16 * 16) {}
  __host__ __device__ int bytes(int nwg) const { return wg0 + nwg * buf; }
};

template <int NS>
__global__ void __launch_bounds__(FWD_MAX_WG * 128)
    embed_fwd_streamed_kernel(const uint32_t* __restrict__ words, const float* __restrict__ w1,
                              const float* __restrict__ b1, __nv_bfloat16* __restrict__ out, int M, int V2, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdStreamLayout L(NS);
  const int nw = fwd_words(V2), pairs = fwd_words_even(V2) / 2;
  const int chunks = (2 * pairs + FWD_STREAM_WORDS - 1) / FWD_STREAM_WORDS;
  const int tid = threadIdx.x;
  const int nwg = blockDim.x >> 7;
  const int h0 = blockIdx.y * NS;
  const int vc = min(NS, H - h0);
  const int F = V2 * PER_CELL + 4;
  float* bias_s = reinterpret_cast<float*>(smem + L.bias);
  for (int n = tid; n < NS; n += blockDim.x) bias_s[n] = n < vc ? bf(__float2bfloat16_rn(b1[h0 + n])) : 0.f;
  const int wg = tid >> 7;
  const int wt = tid & 127;
  const int lane = tid & 31;
  const int wl = wt >> 5;
  const int c = lane & 3;
  const int bar = 1 + wg;
  unsigned char* buf = smem + L.wg0 + wg * L.buf;
  const int tiles = (M + FWD_TILE - 1) / FWD_TILE;
  const uint64_t desc0 = b_desc(smem);

  for (int t0 = blockIdx.x * nwg; t0 < tiles; t0 += gridDim.x * nwg) {
    const int t = t0 + wg;
    const bool live = t < tiles;
    const int m0 = t * FWD_TILE;
    float acc[NS / 2];
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) acc[i] = 0.f;
    for (int ch = 0; ch < chunks; ++ch) {
      const int w0 = ch * FWD_STREAM_WORDS;
      __syncthreads();  // every warpgroup is done with the last chunk (and the last tile's epilogue)
      // The chunk's slab, as the resident kernel lays out the whole slab.
      for (int u = tid; u < FWD_STREAM_WORDS * NS; u += blockDim.x) {
        const int n = 4 * (u % (NS / 4));
        const int g8 = u / (NS / 4);
        const int kl = g8 >> 1, h = g8 & 1;
        float4 x[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int f = fwd_row(2 * w0 + kl, 8 * h + j);
          x[j] = f < F && n < vc ? *reinterpret_cast<const float4*>(w1 + (size_t)f * H + h0 + n)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        unsigned char* dst = smem + kl * NS * 32 + ((n >> 3) * 2 + h) * 128 + (n & 7) * 16;
        *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16(x[0].x, x[1].x), pack_bf16(x[2].x, x[3].x),
                                                    pack_bf16(x[4].x, x[5].x), pack_bf16(x[6].x, x[7].x));
        *reinterpret_cast<uint4*>(dst + 16) = make_uint4(pack_bf16(x[0].y, x[1].y), pack_bf16(x[2].y, x[3].y),
                                                         pack_bf16(x[4].y, x[5].y), pack_bf16(x[6].y, x[7].y));
        *reinterpret_cast<uint4*>(dst + 32) = make_uint4(pack_bf16(x[0].z, x[1].z), pack_bf16(x[2].z, x[3].z),
                                                         pack_bf16(x[4].z, x[5].z), pack_bf16(x[6].z, x[7].z));
        *reinterpret_cast<uint4*>(dst + 48) = make_uint4(pack_bf16(x[0].w, x[1].w), pack_bf16(x[2].w, x[3].w),
                                                         pack_bf16(x[4].w, x[5].w), pack_bf16(x[6].w, x[7].w));
      }
      // The tile's words of the chunk; a row past M and a word past the
      // sample's are zeros.
      uint32_t* wd = reinterpret_cast<uint32_t*>(buf);
      for (int q = wt; q < FWD_TILE * FWD_STREAM_WORDS; q += 128) {
        const int r = q / FWD_STREAM_WORDS, w = w0 + q % FWD_STREAM_WORDS;
        wd[r * L.ws + w - w0] = live && m0 + r < M && w < nw ? words[(size_t)(m0 + r) * nw + w] : 0u;
      }
      fence_proxy_async();  // the slab, written by the generic proxy, is read by wgmma
      __syncthreads();
      if (live) {
        const uint2* wr0 = reinterpret_cast<const uint2*>(buf + (16 * wl + (lane >> 2)) * L.ws * 4);
        const uint2* wr8 = wr0 + 8 * L.ws / 2;
        const int gn = min(FWD_STREAM_WORDS / 2, pairs - w0 / 2);
        for (int g = 0; g < gn; ++g) {
          uint32_t fr[4][4];
          const uint2 x0 = wr0[g], x1 = wr8[g];
#pragma unroll
          for (int k = 0; k < 4; ++k) {  // K tile 4g + k of the chunk: word 2g + k / 2, p = k % 2
            const int sh = c + 4 * (k & 1);
            const uint32_t a0 = (k < 2 ? x0.x : x0.y) << sh, a1 = (k < 2 ? x1.x : x1.y) << sh;
            fr[k][0] = onehot_sign_pair<0>(a0);
            fr[k][1] = onehot_sign_pair<0>(a1);
            fr[k][2] = onehot_sign_pair<2>(a0);
            fr[k][3] = onehot_sign_pair<2>(a1);
          }
          wgmma_fence();
#pragma unroll
          for (int k = 0; k < 4; ++k) fwd_mma<NS>(acc, fr[k], desc0 + (uint64_t)((4 * g + k) * NS * 2));
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int i = 0; i < 4; ++i) fence_operand(fr[k][i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) fence_operand(acc[i]);
    if (!live) continue;
    named_sync(bar, 128);  // every warp is done with the words

    // Epilogue, as the resident kernel's.
    const int rows = min(FWD_TILE, M - m0);
    {
      const int r0 = 16 * wl + (lane >> 2);
      uint32_t* st32 = reinterpret_cast<uint32_t*>(buf);
      const int sw = L.stage_row / 4;
#pragma unroll
      for (int j = 0; j < NS / 8; ++j) {
        const int col = 8 * j + 2 * c;
        const float bx = bias_s[col], by = bias_s[col + 1];
        st32[r0 * sw + col / 2] =
            pack_bf16(bf(__float2bfloat16_rn(acc[4 * j])) + bx, bf(__float2bfloat16_rn(acc[4 * j + 1])) + by);
        st32[(r0 + 8) * sw + col / 2] =
            pack_bf16(bf(__float2bfloat16_rn(acc[4 * j + 2])) + bx, bf(__float2bfloat16_rn(acc[4 * j + 3])) + by);
      }
    }
    named_sync(bar, 128);
    if (vc % 8 == 0) {
      const int upr = vc / 8;
      for (int q = wt; q < rows * upr; q += 128) {
        const int r = q / upr, u = q % upr;
        *reinterpret_cast<uint4*>(out + (size_t)(m0 + r) * H + h0 + 8 * u) =
            *reinterpret_cast<const uint4*>(buf + r * L.stage_row + 16 * u);
      }
    } else {  // H = 4: one 8-byte store per row
      for (int r = wt; r < rows; r += 128) {
        *reinterpret_cast<uint2*>(out + (size_t)(m0 + r) * H) = *reinterpret_cast<const uint2*>(buf + r * L.stage_row);
      }
    }
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

// Hidden sizes of the forward: a multiple of 32 or a power of two, from 4
// to 512 (slabs of 64 columns, the last one the rest of H, whose columns
// past H are zeros; a narrower H is one slab padded to 8).
bool hidden_ok(int H) { return H >= 4 && H <= 512 && (H % 32 == 0 || (H & (H - 1)) == 0); }

// The forward's slab width and warpgroups for V2 view cells at hidden size
// H: the widest slab (64 columns, or H's own width from 8 up) that leaves
// room for two warpgroups, else for one; false if not even an 8-column
// slab and one warpgroup fit.
// The words kernel's threads a block for V2 view cells (WORDS_ROWS samples
// a warp, each a row of V2 + 1 words in shared memory), 0 if none fit.
int words_threads(int V2) {
  int threads = WORDS_THREADS;
  while (threads >= 32 && threads / 32 * WORDS_ROWS * (V2 + 1) * 4 > SMEM_LIMIT) threads /= 2;
  return threads >= 32 ? threads : 0;
}

// The forward's slab width and warpgroups for V2 view cells at width H: the
// widest resident slab beside which two warpgroups fit (v <= 15), or else
// the streamed kernel's (*streamed; on an H100 at M = 131072, H = 256 a
// resident slab of 8 columns with one warpgroup a CTA took 9.9 ms at
// v = 19, the streamed kernel 2.1 ms at v = 21).  False if the words do
// not fit.
bool fwd_config(int V2, int H, int* ns, int* nwg, bool* streamed = nullptr) {
  if (words_threads(V2) == 0) return false;
  if (streamed != nullptr) *streamed = false;
  for (int w = H >= 64 ? 64 : max(8, H); w >= 8; w /= 2) {
    const FwdLayout L(V2, w);
    const int fit = (SMEM_LIMIT - L.bytes(0)) / (2 * L.buf);
    if (fit >= 2) {
      *ns = w;
      *nwg = min(fit, FWD_MAX_WG);
      return true;
    }
  }
  const int w = H >= 64 ? 64 : max(8, H);
  const FwdStreamLayout L(w);
  *ns = w;
  *nwg = min((SMEM_LIMIT - L.bytes(0)) / L.buf, FWD_MAX_WG);
  if (streamed != nullptr) *streamed = true;
  return true;
}

// Hidden sizes of the backward: whole slabs of 64 columns, one a
// warpgroup (a dy of another width comes padded to a multiple of 64).
bool bwd_hidden_ok(int H) { return H >= 64 && H <= 512 && H % 64 == 0; }

// The backward's warpgroups a CTA at width H: 4, 2 or 1, whichever
// divides its slabs of 64 (the grid's third dimension takes the rest).
int bwd_warpgroups(int H) { return (H / 64) % 4 == 0 ? 4 : (H / 64) % 2 == 0 ? 2 : 1; }

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

template <int NS>
cudaError_t launch_fwd(const uint32_t* words, const float* w1, const float* b1, __nv_bfloat16* out, int M, int V2,
                       int H, int nwg, bool streamed, cudaStream_t s) {
  static int sms = 0;
  if (sms == 0) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  const auto kernel = streamed ? embed_fwd_streamed_kernel<NS> : embed_fwd_kernel<NS>;
  const int bytes = streamed ? FwdStreamLayout(NS).bytes(nwg) : FwdLayout(V2, NS).bytes(nwg);
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  // One CTA a slab per SM, no more than the tiles' warpgroups need.
  const int slabs = (H + NS - 1) / NS;
  const int tiles = (M + FWD_TILE - 1) / FWD_TILE;
  const int per_slab = max(1, min(sms / slabs, (tiles + nwg - 1) / nwg));
  kernel<<<dim3(per_slab, slabs), nwg * 128, bytes, s>>>(words, w1, b1, out, M, V2, H);
  return cudaGetLastError();
}

}  // namespace

// The forward's slab width (hidden columns a CTA holds) for V2 view cells
// at hidden size H, or 0 if the forward does not take them.
extern "C" int embed_dense1_fwd_slab_width(int V2, int H) {
  int ns = 0, nwg = 0;
  return V2 >= 1 && hidden_ok(H) && fwd_config(V2, H, &ns, &nwg) ? ns : 0;
}

// The forward's warpgroups per CTA for V2 view cells at hidden size H (0
// where it does not take them).
extern "C" int embed_dense1_fwd_warpgroups(int V2, int H) {
  int ns = 0, nwg = 0;
  return V2 >= 1 && hidden_ok(H) && fwd_config(V2, H, &ns, &nwg) ? nwg : 0;
}

// Whether the forward streams its slab (1) for V2 view cells at hidden
// size H, or holds it resident (0; -1 where it does not take them).
extern "C" int embed_dense1_fwd_streamed(int V2, int H) {
  int ns = 0, nwg = 0;
  bool streamed = false;
  return V2 >= 1 && hidden_ok(H) && fwd_config(V2, H, &ns, &nwg, &streamed) ? (int)streamed : -1;
}

// One-hot words per sample of the forward: the scratch `words` of
// embed_dense1_fwd_launch is int32 [M, this].
extern "C" int embed_dense1_fwd_words(int V2) { return fwd_words(V2); }

// bf16 out [M, H] from packed [M, V2], dir [M], f32 w1 [V2*20+4, H] and f32
// b1 [H] (both rounded to bf16 here); `words` is scratch.
extern "C" int embed_dense1_fwd_launch(const int* packed, const int* dir, const void* w1, const void* b1,
                                       void* words, void* out, int M, int V2, int H, void* stream) {
  int ns = 0, nwg = 0;
  bool streamed = false;
  if (M < 0 || V2 < 1 || !hidden_ok(H) || !fwd_config(V2, H, &ns, &nwg, &streamed)) {
    return (int)cudaErrorInvalidValue;
  }
  if (M == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* wd = static_cast<uint32_t*>(words);
  const int threads = words_threads(V2);
  const int per_block = threads / 32 * WORDS_ROWS;
  const int cb_bytes = per_block * (V2 + 1) * 4;
  if (cb_bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(embed_fwd_words_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, cb_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  embed_fwd_words_kernel<<<(M + per_block - 1) / per_block, threads, cb_bytes, s>>>(packed, dir, wd, M, V2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float* w = static_cast<const float*>(w1);
  const float* b = static_cast<const float*>(b1);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  err = ns == 64   ? launch_fwd<64>(wd, w, b, o, M, V2, H, nwg, streamed, s)
        : ns == 32 ? launch_fwd<32>(wd, w, b, o, M, V2, H, nwg, streamed, s)
        : ns == 16 ? launch_fwd<16>(wd, w, b, o, M, V2, H, nwg, streamed, s)
                   : launch_fwd<8>(wd, w, b, o, M, V2, H, nwg, streamed, s);
  return (int)err;
}

// Dynamic shared memory (bytes) of the backward's pass 1 at hidden size H.
extern "C" int embed_dense1_bwd_smem_bytes(int H) {
  if (!bwd_hidden_ok(H)) return 0;
  const int nwg = bwd_warpgroups(H);
  return nwg == 1 ? BwdSmem<1>::BYTES : nwg == 2 ? BwdSmem<2>::BYTES : BwdSmem<4>::BYTES;
}

// Number of chunks, so the caller can size `part` as [chunks, V2*20+5, H] f32.
extern "C" int embed_dense1_bwd_chunks(int M) { return (M + CHUNK - 1) / CHUNK; }

// f32 dw1 [V2*20+4, H] and db1 [H] from bf16 dy [M, H], H a multiple of 64
// up to 512; `part` is scratch.
extern "C" int embed_dense1_bwd_launch(const int* packed, const int* dir, const void* dy,
                                       float* part, float* dw1, float* db1, int M, int V2, int H,
                                       void* stream) {
  if (M < 1 || V2 < 1 || !bwd_hidden_ok(H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = (M + CHUNK - 1) / CHUNK;
  const int nwg = bwd_warpgroups(H);
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
