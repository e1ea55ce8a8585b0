// Toolchain and gather probes, for Hopper (sm_90a): P1, P2 and P3.
//
// Replace the TPU probes of scripts/pallas_probe.py (_copy_kernel_result,
// _matmul_kernel_result) and scripts/pallas_gather_probe.py
// (pallas_gather).  Plain versions and the entry point that runs them:
// parsy_bench_tpu_torch/probes.py.
//
// P1, copy: y = x, f32, one element per thread in a grid-stride loop.
//
// P2, matmul: C (M, N) = A (M, K) B (K, N), f32, row-major.  16 x 16 output
// tiles, one thread per output, the A and B tiles staged in shared memory
// (padded rows), FMAs on the CUDA cores (no tensor cores, so no TF32).
//
// P3, gather: out[g] = sum_{k < per} pool8[idx[g * per + k]], where pool8
// is (rows8, len) f32 with len = 8c (8 packed rows of width c per index,
// the executor's pool layout) and out is (G, len).  The TPU kernel carried
// one (8, c) accumulator across its sequential grid and so kept only the
// last group's sum; here every group is kept (its last group is the TPU's
// output).  One thread block per group; each thread owns 16-byte columns
// of the packed row and issues the loads of the next kInFlight rows before
// it adds them, so eight loads are in flight per thread: with two in
// flight the probe's 128 blocks reached 0.38 TB/s from HBM, bound by
// latency.  What should bound it: bytes (len * 4 per index), from L2 when
// the pool fits its 50 MB, else from HBM.
// An index outside [0, rows8) reads nothing and poisons its group's sum
// with NaN.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

__global__ void copy_kernel(const float* __restrict__ x,
                            float* __restrict__ y, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    y[i] = x[i];
  }
}

constexpr int kTile = 16;

__global__ void matmul_kernel(const float* __restrict__ a,
                              const float* __restrict__ b,
                              float* __restrict__ c, int M, int N, int K) {
  __shared__ float As[kTile][kTile + 1];
  __shared__ float Bs[kTile][kTile + 1];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int row = blockIdx.y * kTile + ty;
  const int col = blockIdx.x * kTile + tx;
  float acc = 0.0f;
  for (int k0 = 0; k0 < K; k0 += kTile) {
    As[ty][tx] = (row < M && k0 + tx < K)
                     ? a[static_cast<size_t>(row) * K + k0 + tx] : 0.0f;
    Bs[ty][tx] = (k0 + ty < K && col < N)
                     ? b[static_cast<size_t>(k0 + ty) * N + col] : 0.0f;
    __syncthreads();
    for (int k = 0; k < kTile; ++k) {
      acc = fmaf(As[ty][k], Bs[k][tx], acc);
    }
    __syncthreads();
  }
  if (row < M && col < N) {
    c[static_cast<size_t>(row) * N + col] = acc;
  }
}

__device__ __forceinline__ float4 load_row(const float4* __restrict__ pool,
                                           int r, int rows8, int len4,
                                           int col) {
  if (r < 0 || r >= rows8) {
    const float nan = __int_as_float(0x7fc00000);
    return make_float4(nan, nan, nan, nan);
  }
  return pool[static_cast<size_t>(r) * len4 + col];
}

// packed rows whose loads a thread issues before adding them
constexpr int kInFlight = 8;

__global__ void gather_kernel(const float4* __restrict__ pool,
                              const int* __restrict__ idx,
                              float4* __restrict__ out, int rows8, int len4,
                              int per) {
  const int* ig = idx + static_cast<size_t>(blockIdx.x) * per;
  float4* og = out + static_cast<size_t>(blockIdx.x) * len4;
  for (int col = threadIdx.x; col < len4; col += blockDim.x) {
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int k0 = 0; k0 < per; k0 += kInFlight) {
      float4 v[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        v[u] = k0 + u < per
                   ? load_row(pool, __ldg(ig + k0 + u), rows8, len4, col)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        acc.x += v[u].x;
        acc.y += v[u].y;
        acc.z += v[u].z;
        acc.w += v[u].w;
      }
    }
    og[col] = acc;
  }
}

}  // namespace

extern "C" int pbt_probe_copy_f32(const float* x, float* y, int n,
                                  void* stream) {
  if (n <= 0) {
    return 0;
  }
  const int threads = 256;
  const int blocks = std::min((n + threads - 1) / threads, 1024);
  copy_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pbt_probe_matmul_f32(const float* a, const float* b,
                                    float* c, int M, int N, int K,
                                    void* stream) {
  if (M <= 0 || N <= 0) {
    return 0;
  }
  const dim3 threads(kTile, kTile);
  const dim3 blocks((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  matmul_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, c, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pbt_probe_gather_f32(const float* pool, const int* idx,
                                    float* out, int rows8, int len, int G,
                                    int per, void* stream) {
  if (G <= 0) {
    return 0;
  }
  const int len4 = len / 4;
  const int threads = std::min(((len4 + 31) / 32) * 32, 1024);
  gather_kernel<<<G, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(pool), idx,
      reinterpret_cast<float4*>(out), rows8, len4, per);
  return static_cast<int>(cudaGetLastError());
}
