// A stand-in for <cuda_runtime.h> that lets the port's CUDA sources K1,
// K2 and the probes (parsy_bench_tpu_torch/csrc/chol_inverse.cu,
// finalize_fused.cu, chol_blocked.cuh and probes.cu) be compiled with g++
// and run on the CPU, for correctness only.  It covers the subset they
// use: one std::thread per CUDA thread of a 1-D block, the blocks of a
// 1-D grid one after another, std::barrier for __syncthreads and
// __syncwarp, __shfl_sync through a per-warp exchange array, float4 and
// float2, cudaLaunchKernelEx (1-D, its attributes ignored), P2's TF32
// rounding (cvt.rna.tf32.f32) and its warp-collective tensor-core product
// (mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, through the same
// exchange array, from the PTX ISA's fragment tables), and
// dynamic shared memory poisoned with 0xFF bytes (NaN as a float, -1 as
// an int) before each block, so that a read of a slot no thread wrote
// shows in the result.  A static __shared__ array becomes a
// function-local static, which every thread of the (one running) block
// shares.  emu.py rewrites the source's <<<>>> launches into emu_launch
// calls and builds it.  PBT_CUDA_EMU tells a source that it is compiled
// here: inline PTX sits under __CUDA_ARCH__, its stand-in under
// PBT_CUDA_EMU.
#pragma once
#define PBT_CUDA_EMU 1
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
struct float2 { float x, y; };
struct uint4 { unsigned x, y, z, w; };
struct double2 { double x, y; };
inline float2 make_float2(float x, float y) { return float2{x, y}; }
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

// the exchange array: one slot per thread for __shfl_sync, then the
// fragments of the warp's mma (kMmaSlots per thread)
constexpr int kMmaSlots = 6;

inline unsigned emu_float_bits(float x) {
  unsigned u;
  std::memcpy(&u, &x, sizeof u);
  return u;
}
inline float emu_bits_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}

// cvt.rna.tf32.f32: x to 10 mantissa bits, to nearest, ties away from
// zero (the 13 low bits of the f32 pattern cleared); finite x only
inline unsigned emu_cvt_rna_tf32(float x) {
  return (emu_float_bits(x) + 0x1000u) & ~0x1FFFu;
}

// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 with C = D, one warp:
// lane = 4 g + t holds a = {A(g, t), A(g + 8, t), A(g, t + 4),
// A(g + 8, t + 4)}, b = {B(t, g), B(t + 4, g)} and d = {D(g, 2t),
// D(g, 2t + 1), D(g + 8, 2t), D(g + 8, 2t + 1)}.  The unit reads the 19
// high bits of each operand (the low 13 are dropped); a product of two
// such values is exact in f32, and the eight of an entry are added in
// order of k.
inline void emu_mma_m16n8k8_tf32(float (&d)[4], const unsigned (&a)[4],
                                 const unsigned (&b)[2]) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  double* x = g_blk->xchg.data() + blockDim.x + w * 32 * kMmaSlots;
  for (int r = 0; r < 4; ++r)
    x[lane * kMmaSlots + r] = emu_bits_float(a[r] & ~0x1FFFu);
  for (int r = 0; r < 2; ++r)
    x[lane * kMmaSlots + 4 + r] = emu_bits_float(b[r] & ~0x1FFFu);
  __syncwarp();
  const int g = lane / 4, t = lane % 4;
  for (int i = 0; i < 4; ++i) {
    const int row = g + 8 * (i / 2), col = 2 * t + i % 2;
    float acc = d[i];
    for (int k = 0; k < 8; ++k) {
      const float av = static_cast<float>(
          x[((row % 8) * 4 + k % 4) * kMmaSlots + row / 8 + 2 * (k / 4)]);
      const float bv = static_cast<float>(
          x[(col * 4 + k % 4) * kMmaSlots + 4 + k / 4]);
      acc += av * bv;
    }
    d[i] = acc;
  }
  __syncwarp();
}

// a shared-memory address as wgmma descriptors hold it: the byte offset
// into the block's shared memory
inline unsigned emu_smem_addr(const void* p) {
  return static_cast<unsigned>(static_cast<const unsigned char*>(p)
                               - smem_raw);
}

// wgmma.mma_async.sync.aligned.m64nNk8.f32.tf32.tf32 with A in registers
// and B in shared memory (K-major, no swizzle), one warpgroup (the block's
// 128 threads): thread 32 w + 4 g + t holds A's fragment of rows 16w..
// 16w + 15 as mma.m16n8k8 does and d[4j .. 4j + 3] = D(16w + g (+ 8),
// 8j + 2t (+ 1)).  The descriptor holds B's start address, the leading
// byte offset (between core matrices along K) and the stride byte offset
// (between 8-row groups along N), each >> 4; B(k, n) lies at start +
// (n / 8) SBO + (k / 4) LBO + (n % 8) 16 + (k % 4) 4 bytes.  The operands'
// low 13 bits are dropped, as by the unit.
template <int NW>
inline void emu_wgmma_m64nNk8_tf32(float (&d)[NW / 2], const unsigned (&a)[4],
                                   unsigned long long desc) {
  const int tid = threadIdx.x;
  double* x = g_blk->xchg.data() + blockDim.x;
  for (int r = 0; r < 4; ++r)
    x[tid * kMmaSlots + r] = emu_bits_float(a[r] & ~0x1FFFu);
  __syncthreads();
  const unsigned char* base = smem_raw + ((desc & 0x3FFF) << 4);
  const size_t lbo = ((desc >> 16) & 0x3FFF) << 4;
  const size_t sbo = ((desc >> 32) & 0x3FFF) << 4;
  const int w = tid / 32, g = tid % 32 / 4, t = tid % 4;
  for (int j = 0; j < NW / 8; ++j) {
    for (int i = 0; i < 4; ++i) {
      const int row = 16 * w + g + 8 * (i / 2), col = 8 * j + 2 * t + i % 2;
      float acc = d[4 * j + i];
      for (int k = 0; k < 8; ++k) {
        const int src = row / 16 * 32 + row % 8 * 4 + k % 4;
        const float av = static_cast<float>(
            x[src * kMmaSlots + row % 16 / 8 + 2 * (k / 4)]);
        unsigned bits;
        std::memcpy(&bits, base + col / 8 * sbo + k / 4 * lbo
                               + col % 8 * 16 + k % 4 * 4, sizeof bits);
        acc += av * emu_bits_float(bits & ~0x1FFFu);
      }
      d[4 * j + i] = acc;
    }
  }
  __syncthreads();
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
    blk.xchg.assign(threads * (1 + kMmaSlots), 0.0);
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
