// A stand-in for <cuda_runtime.h> that lets the port's CUDA sources K1,
// K2 and the probes (parsy_bench_tpu_torch/csrc/chol_inverse.cu,
// finalize_fused.cu, chol_blocked.cuh and probes.cu) be compiled with g++
// and run on the CPU, for correctness only.  It covers the subset they
// use: one std::thread per CUDA thread of a 1-D block, the blocks of a
// 1-D grid one after another, std::barrier for __syncthreads and
// __syncwarp, __shfl_sync through a per-warp exchange array, float4,
// cudaLaunchKernelEx (1-D, its attributes ignored), and
// dynamic shared memory poisoned with 0xFF bytes (NaN as a float, -1 as
// an int) before each block, so that a read of a slot no thread wrote
// shows in the result.  A static __shared__ array becomes a
// function-local static, which every thread of the (one running) block
// shares.  emu.py rewrites the source's <<<>>> launches into emu_launch
// calls and builds it.
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
#define __shared__ static

using std::fma;
using std::fmaf;
using std::max;
using std::min;
using std::sqrt;
inline float rsqrt(float x) { return 1.0f / std::sqrt(x); }
inline double rsqrt(double x) { return 1.0 / std::sqrt(x); }

struct dim3e { int x = 0, y = 0, z = 0; };
inline thread_local dim3e threadIdx, blockIdx, blockDim, gridDim;

struct float4 { float x, y, z, w; };
struct double2 { double x, y; };
inline float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
}
inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, sizeof f);
  return f;
}

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
void emu_launch(K kernel, int grid, int threads, size_t smem, A... args);

// cudaLaunchKernelEx with a 1-D grid; launch attributes change nothing
// here (blocks run one after another)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
enum cudaLaunchAttributeID {
  cudaLaunchAttributeProgrammaticStreamSerialization = 5
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  struct {
    int programmaticStreamSerializationAllowed;
  } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
template <typename... P, typename... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                               void (*kernel)(P...), A... args) {
  if (cfg->gridDim.y != 1 || cfg->gridDim.z != 1 || cfg->blockDim.y != 1
      || cfg->blockDim.z != 1)
    return cudaErrorInvalidValue;
  emu_launch(kernel, static_cast<int>(cfg->gridDim.x),
             static_cast<int>(cfg->blockDim.x), cfg->dynamicSmemBytes,
             static_cast<P>(args)...);
  return cudaSuccess;
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
        blockDim.x = threads;
        gridDim.x = grid;
        kernel(args...);
      });
    for (auto& t : ts) t.join();
  }
}
