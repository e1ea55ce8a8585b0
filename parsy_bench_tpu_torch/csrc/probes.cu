// Toolchain and gather probes, for Hopper (sm_90a): P1, P2 and P3.
//
// Replace the TPU probes of scripts/pallas_probe.py (_copy_kernel_result,
// _matmul_kernel_result) and scripts/pallas_gather_probe.py
// (pallas_gather).  Plain versions and the entry point that runs them:
// parsy_bench_tpu_torch/probes.py.
//
// P1, copy: y = x, f32.  One thread per 16-byte vector when both pointers
// are 16-byte aligned, and a tail of at most 3 floats; the launch is sized
// to the tensor (one block of 256 threads at 8 x 128).  Bit-equal to its
// input.  At 4 KB the call is its launch: launched plainly, the copy took
// 0.00202 ms back to back against 0.00192 ms for x.clone() (a
// cudaMemcpyAsync) on an H100 (chip_smoke.py phase 10; PERF.md section
// 6).  So the copy is launched with Hopper's programmatic stream
// serialization (0.00098 ms there): its launch and block set-up overlap
// the tail of the kernel before it in the stream, and griddepcontrol.wait
// holds every load and store until that kernel has finished and its
// writes are visible, so ordering is as with a plain launch.
//
// P2, matmul: C (M, N) = A (M, K) B (K, N), f32, row-major.  16 x 16 output
// tiles, one thread per output, the A and B tiles staged in shared memory
// (padded rows), FMAs on the CUDA cores (no tensor cores, so no TF32).
//
// P3, gather-and-sum: out[g] = sum_{k < per} pool[idx[g * per + k]], pool
// (rows, w) f32 with w % 4 == 0 and out (G, w).  Two callers: the TPU
// probe, whose pool is the executor's packed layout (w = 8c, 4 KB rows at
// c = 128, per = 32), and the executor's ladder sums call[gi[t]].sum(1)
// (w = c = 32 or 128, so 128- or 512-byte rows, per = m from 1 to 128,
// up to 32,005 groups; index 0 is the zero row).  The TPU kernel carried
// one accumulator across its sequential grid and so kept only the last
// group's sum; here every group is kept.
//
// What bounds it: bytes, each distinct row read once, from HBM when the
// pool is cold, and below a few MB the latency of a launch and of two
// dependent memory round trips (index, then rows).  The design keeps
// enough rows in flight at every width and every per:
//   * work item = (group, chunk of up to 32 16-byte columns), worked by a
//     team of tw lanes (tw = the row's float4 count rounded up to a power
//     of two, at most 32), so a warp holds 4 teams at w = 32 and every
//     lane loads (one warp per 128-byte row left 24 of 32 lanes idle);
//   * each thread loads its rows' indices itself (staging a block's
//     indices in shared memory would put a block barrier on every block's
//     latency chain) and starts kDepth row loads before it adds any;
//   * a group's per rows are split over `splits` sub-teams while the grid
//     holds fewer than about one wave of threads (kTargetThreads), so a
//     small grid of long groups still has its rows in flight at once (at
//     m = 128 and 115 groups: 16 sub-teams, one round trip instead of
//     16); the partial sums meet in shared memory and sub-team 0 adds
//     them in a fixed order;
//   * blocks of 256 threads (or one item's team, up to 1,024), as many as
//     the items need: the probe's 128 groups of 4 KB give 512 blocks of
//     4 sub-teams, 128 KB in flight per SM.
// Measured on an H100 by chip_smoke.py phase 10 and, against another
// checkout's kernel, by tools/p3_ab.py (PERF.md section 6).  Hopper's
// bulk copies (cp.async.bulk into shared memory) were weighed and not
// taken: register loads already put a wave's rows in flight, and at
// w = 32 a bulk copy per 128-byte row would cost one copy instruction and
// barrier update per row, with a shared-memory round trip on top.
// An index outside [0, rows) reads nothing and poisons its group's sum
// with NaN.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

// wait until the grids this one depends on have completed and their
// memory operations are visible (a no-op without a programmatic launch)
__device__ __forceinline__ void wait_prior_grids() {
#if defined(__CUDA_ARCH__)
  asm volatile("griddepcontrol.wait;" ::: "memory");
#endif
}

__global__ void copy_kernel(const float* __restrict__ x,
                            float* __restrict__ y, int n, int n4) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  wait_prior_grids();
  if (i < n4) {
    reinterpret_cast<float4*>(y)[i] = reinterpret_cast<const float4*>(x)[i];
  }
  if (i < n - 4 * n4) {
    y[4 * n4 + i] = x[4 * n4 + i];
  }
}

constexpr int kTile = 16;

// one thread per output of a 16 x 16 tile; the grid's blocks walk the
// tiles row by row (blockIdx.x = tile row * nbx + tile column)
__global__ void matmul_kernel(const float* __restrict__ a,
                              const float* __restrict__ b,
                              float* __restrict__ c, int M, int N, int K,
                              int nbx) {
  __shared__ float As[kTile][kTile + 1];
  __shared__ float Bs[kTile][kTile + 1];
  const int tx = threadIdx.x % kTile;
  const int ty = threadIdx.x / kTile;
  const int row = blockIdx.x / nbx * kTile + ty;
  const int col = blockIdx.x % nbx * kTile + tx;
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
                                           int r, int rows, int len4,
                                           int col) {
  if (r < 0 || r >= rows) {
    const float nan = __int_as_float(0x7fc00000);
    return make_float4(nan, nan, nan, nan);
  }
  return pool[static_cast<size_t>(r) * len4 + col];
}

__device__ __forceinline__ void add4(float4& acc, const float4& v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

// rows a thread loads before it adds them
constexpr int kDepth = 8;
constexpr int kMinThreads = 256;
constexpr int kMaxThreads = 1024;
// threads in flight the launch aims for: about one wave of 1,024 threads
// on each of the H100's 132 SMs; a group's rows are split over more
// sub-teams only while the grid holds fewer
constexpr long long kTargetThreads = 128 * 1024;

// thread t of the grid: lane t % tw of sub-team (t / tw) % splits of item
// t / (tw * splits), item = g * nchunk + column chunk; tw = 2^lt and
// splits = 2^ls, so that the index math is shifts and masks (a division by
// a runtime value is a long dependent chain at the head of every thread's
// latency chain).  A block holds whole teams.  Shared memory (splits > 1):
// the partial sums, blockDim.x float4.
__global__ void __launch_bounds__(kMaxThreads)
    gather_sum_kernel(const float4* __restrict__ pool,
                      const int* __restrict__ idx, float4* __restrict__ out,
                      int rows, int len4, int G, int per, int lt, int ls,
                      int nchunk, int ks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* part = reinterpret_cast<float4*>(smem_raw);
  const int t = threadIdx.x;
  const int lane = t & ((1 << lt) - 1);
  const int s = (t >> lt) & ((1 << ls) - 1);
  const int item = static_cast<int>(
      (static_cast<unsigned>(blockIdx.x) * blockDim.x + t) >> (lt + ls));
  const int g = nchunk == 1 ? item : item / nchunk;
  const int col = (nchunk == 1 ? 0 : (item - g * nchunk) << lt) + lane;
  const bool live = item < G * nchunk && col < len4;

  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (live) {
    const int* ig = idx + static_cast<size_t>(g) * per;
    const int kend = min(per, (s + 1) * ks);
    for (int k0 = s * ks; k0 < kend; k0 += kDepth) {
      float4 v[kDepth];
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        v[u] = k0 + u < kend ? load_row(pool, ig[k0 + u], rows, len4, col)
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        add4(acc, v[u]);
      }
    }
  }
  float4* og = out + static_cast<size_t>(g) * len4 + col;
  if (ls == 0) {
    if (live) {
      *og = acc;
    }
    return;
  }
  part[t] = acc;
  __syncthreads();
  if (live && s == 0) {
    for (int q = 1; q < 1 << ls; ++q) {
      add4(acc, part[t + (q << lt)]);
    }
    *og = acc;
  }
}

// the least l with 2^l >= x
int log2ceil(int x) {
  int l = 0;
  while ((1 << l) < x) {
    ++l;
  }
  return l;
}

}  // namespace

extern "C" int pbt_probe_copy_f32(const float* x, float* y, int n,
                                  void* stream) {
  if (n <= 0) {
    return 0;
  }
  const bool aligned = ((reinterpret_cast<std::uintptr_t>(x)
                         | reinterpret_cast<std::uintptr_t>(y)) & 15) == 0;
  const int n4 = aligned ? n / 4 : 0;
  const int work = std::max(n4, n - 4 * n4);
  const int threads = std::min(256, (work + 31) / 32 * 32);
  const int blocks = (work + threads - 1) / threads;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, copy_kernel, x, y, n, n4);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" int pbt_probe_matmul_f32(const float* a, const float* b,
                                    float* c, int M, int N, int K,
                                    void* stream) {
  if (M <= 0 || N <= 0) {
    return 0;
  }
  const int nbx = (N + kTile - 1) / kTile;
  const int blocks = nbx * ((M + kTile - 1) / kTile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  matmul_kernel<<<blocks, kTile * kTile, 0, s>>>(a, b, c, M, N, K, nbx);
  return static_cast<int>(cudaGetLastError());
}

// pool (rows, w) f32, 16-byte aligned with w % 4 == 0; idx (G * per,)
// int32; out (G, w).  32 G ceil(w / 128) < 2^31 (checked by the wrapper),
// so the grid's thread count fits 32 bits.
extern "C" int pbt_gather_sum_f32(const float* pool, const int* idx,
                                  float* out, int rows, int w, int G,
                                  int per, void* stream) {
  if (G <= 0) {
    return 0;
  }
  if (w <= 0 || w % 4 != 0 || per <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int len4 = w / 4;
  const int lt = std::min(5, log2ceil(len4));
  const int nchunk = (len4 + (1 << lt) - 1) >> lt;
  const long long base = static_cast<long long>(G) * nchunk << lt;
  int ls = std::min(log2ceil((per + kDepth - 1) / kDepth),
                    log2ceil(kMaxThreads) - lt);
  while (ls > 0 && base << ls > kTargetThreads) {
    --ls;
  }
  const int ks = (per + (1 << ls) - 1) >> ls;
  const int team = 1 << (lt + ls);
  const int threads = std::max(team, kMinThreads);
  const int blocks = static_cast<int>((base << ls) / threads
                                      + ((base << ls) % threads != 0));
  const size_t smem = ls > 0 ? threads * sizeof(float4) : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gather_sum_kernel<<<blocks, threads, smem, s>>>(
      reinterpret_cast<const float4*>(pool), idx,
      reinterpret_cast<float4*>(out), rows, len4, G, per, lt, ls, nchunk,
      ks);
  return static_cast<int>(cudaGetLastError());
}
