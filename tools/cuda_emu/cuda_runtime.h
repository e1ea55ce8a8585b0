// A stand-in for <cuda_runtime.h> that lets the port's CUDA sources K1
// and K2 (parsy_bench_tpu_torch/csrc/chol_inverse.cu, finalize_fused.cu
// and chol_blocked.cuh) be compiled with g++ and run on the CPU, for
// correctness only.  It covers the subset they use: one std::thread per
// CUDA thread, the blocks of a grid one after another, std::barrier for
// __syncthreads and __syncwarp,
// __shfl_sync through a per-warp exchange array, and dynamic shared memory
// poisoned with 0xFF bytes (NaN) before each block, so that a read of a
// slot no thread wrote shows in the result.  emu.py rewrites the
// source's <<<>>> launches into emu_launch calls and builds it.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
#define __align__(n) __attribute__((aligned(n)))
#define __shared__

using std::fma;
using std::max;
using std::min;
using std::sqrt;
inline float rsqrt(float x) { return 1.0f / std::sqrt(x); }
inline double rsqrt(double x) { return 1.0 / std::sqrt(x); }

struct dim3e { int x = 0, y = 0, z = 0; };
inline thread_local dim3e threadIdx, blockIdx;

struct float4 { float x, y, z, w; };
struct double2 { double x, y; };

typedef void* cudaStream_t;
typedef int cudaError_t;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
// the H100's opt-in limit of dynamic shared memory per block
template <typename F>
inline cudaError_t cudaFuncSetAttribute(F, int, int bytes) {
  return bytes <= 232448 ? cudaSuccess : 2;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

alignas(16) inline unsigned char smem_raw[256 * 1024];

struct EmuBlock {
  std::unique_ptr<std::barrier<>> block;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::vector<double> xchg;
};
inline EmuBlock* g_blk = nullptr;

inline void __syncthreads() { g_blk->block->arrive_and_wait(); }
inline void __syncwarp() { g_blk->warps[threadIdx.x / 32]->arrive_and_wait(); }
template <typename T>
inline T __shfl_sync(unsigned, T v, int src) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncwarp();
  g_blk->xchg[w * 32 + lane] = static_cast<double>(v);
  __syncwarp();
  T out = static_cast<T>(g_blk->xchg[w * 32 + src]);
  __syncwarp();
  return out;
}

template <typename K, typename... A>
void emu_launch(K kernel, int grid, int threads, size_t smem, A... args) {
  if (smem > sizeof(smem_raw)) throw 1;
  for (int b = 0; b < grid; ++b) {
    EmuBlock blk;
    blk.block = std::make_unique<std::barrier<>>(threads);
    for (int w = 0; w < threads / 32; ++w)
      blk.warps.push_back(std::make_unique<std::barrier<>>(32));
    blk.xchg.assign(threads, 0.0);
    g_blk = &blk;
    std::memset(smem_raw, 0xFF, sizeof(smem_raw));
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([=] {
        threadIdx.x = t;
        blockIdx.x = b;
        kernel(args...);
      });
    for (auto& t : ts) t.join();
  }
}
