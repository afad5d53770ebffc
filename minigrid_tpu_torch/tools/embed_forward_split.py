"""Where K3's forward spends its time on the card: a phase split and the
tensor cores' rate at its product's shape.

Run it on the GPU, from the repository's root:

    python -m minigrid_tpu_torch.tools.embed_forward_split

It builds three instrumented copies of ``ops/csrc/embed_dense.cu`` and a
microbenchmark under ``ops/build/split/`` (nothing of the package's own
build changes):

* ``kernel``: the forward as it is, with ``clock64()`` sums per phase: the
  slab load (per CTA) and, per M tile and warpgroup, the wait for its words,
  the products, and the epilogue with its stores;
* ``builds``: the same without the ``wgmma``s (the A-fragment builds and
  the warpgroup's synchronisation alone);
* ``wgmma``: the same without the fragment builds after the first groups
  (the ``wgmma``s on the first groups' registers);
* ``rate``: ``wgmma`` m64nNk16 with A in registers and B in shared memory,
  groups of four a fence, commit and wait, at N = 32, 64, 128 from 1, 2 and
  4 warpgroups a CTA, one CTA per SM.

At M = 131072, H = 256 (a PPO minibatch; object-rich 9x7 states, v = 7) it
prints the card, each copy's device time per call behind a spin kernel, its
split in cycles, the words kernel's time alone, and the microbenchmark's
cycles per ``wgmma`` per SM.  Only ``kernel``'s outputs are checked (against
the plain version); the other two compute nothing meaningful.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from minigrid_tpu_torch.core.env import MiniGridEnv
from minigrid_tpu_torch.ops import _build
from minigrid_tpu_torch.ops import embed_dense as ed
from minigrid_tpu_torch.utils.bridge import state_from_numpy
from minigrid_tpu_torch.utils.synthetic import random_states

M, V2, H = 131072, 49, 256
SPIN_CYCLES = 100_000_000
OUT = _build.BUILD_DIR / "split"

_DECLARE = "__device__ unsigned long long g_split[8];\n"
_EXPORTS = """
extern "C" int split_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_split, sizeof(g_split));
}
extern "C" int split_reset() {
  unsigned long long z[8] = {0};
  return (int)cudaMemcpyToSymbol(g_split, z, sizeof(z));
}
extern "C" int words_only(const int* packed, const int* dir, void* words, int M, int V2, void* stream) {
  const int per_block = WORDS_THREADS / 32 * WORDS_ROWS;
  embed_fwd_words_kernel<<<(M + per_block - 1) / per_block, WORDS_THREADS, per_block * (V2 + 1) * 4,
                           static_cast<cudaStream_t>(stream)>>>(packed, dir, static_cast<uint32_t*>(words), M, V2);
  return (int)cudaGetLastError();
}
"""

# (anchor, text inserted after it): the clock64() sums of `kernel`.
_PROBES = (
    ("  float* bias_s = reinterpret_cast<float*>(smem + L.bias);\n", "  long long t0 = clock64();\n"),
    (
        "  fence_proxy_async();  // the slab, written by the generic proxy, is read by wgmma\n  __syncthreads();\n",
        "  if (threadIdx.x == 0) atomicAdd(&g_split[0], (unsigned long long)(clock64() - t0));\n"
        "  long long t1 = clock64();\n",
    ),
    (
        "    named_sync(bar, 128);  // tile t's words are in; every thread is done with the other buffer\n",
        "    long long t2 = clock64();\n"
        "    if ((tid & 127) == 0) atomicAdd(&g_split[1], (unsigned long long)(t2 - t1));\n",
    ),
    (
        "    named_sync(bar, 128);  // every warp is done with the words\n",
        "    long long t3 = clock64();\n"
        "    if ((tid & 127) == 0) atomicAdd(&g_split[2], (unsigned long long)(t3 - t2));\n",
    ),
    (
        "        *reinterpret_cast<uint2*>(out + (size_t)(m0 + r) * H) = "
        "*reinterpret_cast<const uint2*>(buf + r * L.stage_row);\n      }\n    }\n",
        "    t1 = clock64();\n"
        "    if ((tid & 127) == 0) {\n"
        "      atomicAdd(&g_split[3], (unsigned long long)(t1 - t3));\n"
        "      atomicAdd(&g_split[4], 1ull);\n"
        "    }\n",
    ),
)
_MMA = "      for (int k = 0; k < 4; ++k) fwd_mma<NS>(acc, cur[k], desc0 + (uint64_t)((4 * g + k) * NS * 2));\n"
_NO_MMA = (
    "      for (int k = 0; k < 4; ++k)\n"
    "        acc[0] += __uint_as_float(cur[k][0] ^ cur[k][1] ^ cur[k][2] ^ cur[k][3]) * 1e-30f;\n"
)
_BUILD = "      if (g + 2 < L.pairs) build(g + 2, nxt);\n"
_NO_BUILD = "      if (g + 2 < L.pairs && g < 2) build(g + 2, nxt);\n"

_RATE = r"""
#include <cuda_bf16.h>
#include <stdint.h>
#include "hopper.cuh"
using namespace hopper;
__device__ unsigned long long g_cycles;
template <int N>
__device__ __forceinline__ void mma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (N == 32) wgmma_m64n32k16_rs(d, a, desc);
  else if constexpr (N == 64) wgmma_m64n64k16_rs(d, a, desc);
  else wgmma_m64n128k16_rs(d, a, desc);
}
template <int N>
__global__ void rate_kernel(int iters, float* out) {
  extern __shared__ __align__(128) unsigned char smem[];
  for (int i = threadIdx.x; i < 16 * N * 8; i += blockDim.x) reinterpret_cast<uint32_t*>(smem)[i] = 0x3F803F80u * (i & 1);
  fence_proxy_async();
  __syncthreads();
  float acc[N / 2];
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  const uint32_t a[4] = {0x3F803F80u, 0x3F80u, 0x3F800000u, 0u};
  const uint64_t d0 = b_desc(smem);
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) mma<N>(acc, a, d0 + (uint64_t)(((4 * it + k) % 16) * N * 2));
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  for (int i = 0; i < N / 2; ++i) fence_operand(acc[i]);
  const long long t1 = clock64();
  if ((threadIdx.x & 127) == 0 && blockIdx.x == 0) atomicAdd(&g_cycles, (unsigned long long)(t1 - t0));
  float s = 0.f;
  for (int i = 0; i < N / 2; ++i) s += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <int N>
int launch(int nwg, int iters, float* out, int sms) {
  const int bytes = 16 * N * 32;
  cudaError_t e = cudaFuncSetAttribute(rate_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  rate_kernel<N><<<sms, nwg * 128, bytes>>>(iters, out);
  return (int)cudaGetLastError();
}
// Cycles warpgroup 0 of CTA 0 summed over its warpgroups, for `iters` groups of 4.
extern "C" int rate(int n, int nwg, int iters, float* out, int sms, unsigned long long* cycles) {
  const unsigned long long z = 0;
  cudaMemcpyToSymbol(g_cycles, &z, sizeof(z));
  const int err = n == 32 ? launch<32>(nwg, iters, out, sms) : n == 64 ? launch<64>(nwg, iters, out, sms)
                                                                         : launch<128>(nwg, iters, out, sms);
  if (err) return err;
  const cudaError_t e = cudaDeviceSynchronize();
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol(cycles, g_cycles, sizeof(z));
}
"""


def _instrumented(mma: bool, builds: bool) -> str:
    src = (_build.CSRC / "embed_dense.cu").read_text()
    for anchor, text in _PROBES:
        if anchor not in src:
            raise RuntimeError(f"embed_dense.cu changed: no anchor {anchor!r}")
        src = src.replace(anchor, anchor + text, 1)
    for anchor, text, keep in ((_MMA, _NO_MMA, mma), (_BUILD, _NO_BUILD, builds)):
        if anchor not in src:
            raise RuntimeError(f"embed_dense.cu changed: no anchor {anchor!r}")
        if not keep:
            src = src.replace(anchor, text, 1)
    head, sep, rest = src.partition("namespace {\n")
    return head + _DECLARE + sep + rest + _EXPORTS


def _compile(name: str, source: str) -> ctypes.CDLL:
    path = OUT / f"{name}.cu"
    path.write_text(source)
    lib = OUT / f"{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib), str(path)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {path.name}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib))


def _device_ms(fn, reps: int) -> float:
    """Device milliseconds per call, the host's enqueueing hidden behind a
    spin kernel."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("embed_forward_split: no CUDA device")
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    print(card, flush=True)
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    sources = {
        "kernel": _instrumented(True, True),
        "builds": _instrumented(False, True),
        "wgmma": _instrumented(True, False),
        "rate": _RATE,
    }
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(_compile, sources, sources.values())))
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)

    rng = np.random.default_rng(11)
    env = MiniGridEnv(9, 7, max_steps=100)
    states = state_from_numpy(random_states(rng, (M,), 9, 7), device)
    packed = env.observation_packed(states).contiguous()
    direction = states.agent_dir.contiguous()
    w1 = torch.from_numpy(rng.normal(0, 0.03, (V2 * 20 + 4, H)).astype(np.float32)).to(device)
    b1 = torch.from_numpy(rng.normal(0, 0.1, H).astype(np.float32)).to(device)
    words = torch.empty((M, (V2 * 20 + 4 + 31) // 32), dtype=torch.int32, device=device)
    out = torch.empty((M, H), dtype=torch.bfloat16, device=device)
    want = ed.embed_dense1_reference(w1, b1, packed, direction)
    ptrs = [t.data_ptr() for t in (packed, direction, w1, b1, words, out)]

    def call(lib):
        fn = lib.embed_dense1_fwd_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        return lambda: fn(*ptrs, M, V2, H, torch.cuda.current_stream().cuda_stream)

    counts = (ctypes.c_ulonglong * 8)()
    for name in ("kernel", "builds", "wgmma"):
        lib = libs[name]
        ms = _device_ms(call(lib), 20)
        lib.split_reset()
        if call(lib)() != 0:
            raise RuntimeError(f"{name}: launch failed")
        torch.cuda.synchronize()
        lib.split_read(counts)
        if name == "kernel":
            err = float((out.float() - want.float()).abs().max())
            if err > 2e-2:
                raise RuntimeError(f"the instrumented kernel differs from the plain version by {err}")
        slab, wait, products, epilogue, tiles = list(counts)[:5]
        print(
            f"{name} ({card}) M={M} H={H}: {ms:.4f} ms a call; slab {slab / 132:.0f} cycles a CTA; per M tile and "
            f"warpgroup: wait {wait / tiles:.0f}, products {products / tiles:.0f}, epilogue and stores "
            f"{epilogue / tiles:.0f} cycles ({tiles} tiles)",
            flush=True,
        )
    words_only = libs["kernel"].words_only
    words_only.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    ms = _device_ms(lambda: words_only(*ptrs[:2], ptrs[4], M, V2, torch.cuda.current_stream().cuda_stream), 50)
    print(f"words kernel alone ({card}) M={M}: {ms:.4f} ms a call", flush=True)

    rate = libs["rate"].rate
    rate.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    sink = torch.empty(sms * 512, device=device)
    cycles = ctypes.c_ulonglong()
    iters = 2000
    for n in (32, 64, 128):
        for nwg in (1, 2, 4):
            if n == 128 and nwg == 4:
                continue  # 64 accumulators a thread at 512 threads: past the register file
            if rate(n, nwg, iters, sink.data_ptr(), sms, ctypes.byref(cycles)) != 0:
                raise RuntimeError(f"rate m64n{n}k16 at {nwg} warpgroups failed")
            per_sm = cycles.value / nwg / (4 * iters * nwg)
            print(
                f"wgmma m64n{n}k16 RS ({card}), {nwg} warpgroups a CTA: {per_sm:.1f} cycles per wgmma per SM, "
                f"{64 * n * 16 / per_sm:.0f} multiply-adds a cycle per SM",
                flush=True,
            )


if __name__ == "__main__":
    main()
