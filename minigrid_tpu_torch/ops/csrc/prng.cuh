// Counter-based PRNG of the kernels: Threefry-2x32 with 20 rounds and the
// multiply-shift index draw.
//
// Device twin of minigrid_tpu_torch/ops/prng.py (and of the JAX package's
// minigrid_tpu/ops/prng.py): the same words for the same key and counter,
// so the kernel's in-episode draws and level generation equal the plain
// versions bit for bit.  Verified against the Random123 known-answer
// vectors through the plain version (tests/test_torch_prng.py).

#pragma once

#include <stdint.h>

namespace minigrid {

struct Words {
  uint32_t w0, w1;
};

__device__ __forceinline__ void threefry_mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = (x1 << r) | (x1 >> (32 - r));
  x1 ^= x0;
}

// Key (k0, k1), counter (x0, x1) -> two uniform words.  Rotation schedule
// and key injection of Random123's threefry2x32_20.
__device__ __forceinline__ Words threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  threefry_mix(x0, x1, 13); threefry_mix(x0, x1, 15); threefry_mix(x0, x1, 26); threefry_mix(x0, x1, 6);
  x0 += k1; x1 += k2 + 1u;
  threefry_mix(x0, x1, 17); threefry_mix(x0, x1, 29); threefry_mix(x0, x1, 16); threefry_mix(x0, x1, 24);
  x0 += k2; x1 += k0 + 2u;
  threefry_mix(x0, x1, 13); threefry_mix(x0, x1, 15); threefry_mix(x0, x1, 26); threefry_mix(x0, x1, 6);
  x0 += k0; x1 += k1 + 3u;
  threefry_mix(x0, x1, 17); threefry_mix(x0, x1, 29); threefry_mix(x0, x1, 16); threefry_mix(x0, x1, 24);
  x0 += k1; x1 += k2 + 4u;
  threefry_mix(x0, x1, 13); threefry_mix(x0, x1, 15); threefry_mix(x0, x1, 26); threefry_mix(x0, x1, 6);
  x0 += k2; x1 += k0 + 5u;
  return Words{x0, x1};
}

// An index in [0, count) from one word: the top 24 bits times count, shifted
// down by 24, in 64-bit arithmetic (the JAX package's int32 product wraps
// for count > 128; the two agree below that).
__device__ __forceinline__ int uniform_index(uint32_t bits, int count) {
  return (int)(((uint64_t)(bits >> 8) * (uint64_t)(uint32_t)count) >> 24);
}

}  // namespace minigrid
