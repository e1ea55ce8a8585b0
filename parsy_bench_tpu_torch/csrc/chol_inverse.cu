// Batched masked-SPD Cholesky with triangular inverse, for Hopper (sm_90a).
//
// Replaces the TPU kernel pallas_kernels.cholesky_inverse_pallas
// (parsy_bench_tpu/ops/pallas_kernels.py).  For each of P blocks D (c, c),
// row-major and contiguous, it writes the lower-triangular L with
// L L^T = D and Linv = L^{-1}; both have exact zeros above the diagonal.
// Only the lower triangle of D is read as the matrix.  Plain version and
// oracle: parsy_bench_tpu_torch/ops/dense.py cholesky_inverse; the kernel's
// block order in plain PyTorch: ops/dense.py cholesky_inverse_panels.
//
// What bounds it on this card, and what the design does about each:
//   c <= 32 (the leaf batch, 27,520 x 32 x 32 at laplace_3d(48)): bytes.
//     D's lower triangle is read once (80 of its 128 sectors of 32 B)
//     and L and Linv written once, 10.5 KB per block in f32, 296 MB for
//     the leaf (0.088 ms at 3.35 TB/s).  One warp
//     owns one block, four warps a CTA, so many blocks are in flight and
//     one warp's loads and stores overlap other warps' chains.  A warp
//     stages its block with all loads in flight at once, and its chain
//     runs on registers, shuffles and __syncwarp (chol_blocked.cuh
//     warp_chol_inverse): the factor and the substitution for Linv share
//     one 32-step loop, with no block barrier and no integer division.
//   32 < c <= 128 (the c = 128 class, P <= 87 there): launch and chain
//     latency.  P blocks are at most one wave on 132 SMs, so a call lasts
//     one block's dependent chain.  A blocked right-looking Cholesky in
//     32-wide panels shortens it: one warp factors and inverts the
//     diagonal panel with the routine above, all 8 warps form the panel
//     below as L21 = A21 Linv11^T (the TPU kernel's TRSM-as-product), and
//     the trailing update runs in 32 x 32 blocks, one warp each, while
//     warp 0 updates, factors and inverts the next diagonal panel
//     (look-ahead).  Linv comes from block forward substitution, one block
//     row after another.  At c = 128: 14 block barriers and four 32-step
//     warp chains, against 256 barriers and an 8,128-long serial
//     substitution in a scalar column-by-column chain.
// At P = 1 to 4 the launch itself (a few microseconds) is the floor.
//
// Numerics: FMAs on the CUDA cores (no tensor cores, so no TF32); pivots
// through rsqrt (chol_blocked.cuh).  A non-positive pivot gives NaN (or
// inf); nothing is clamped.  An identity block comes out exactly as
// identity.

#include <cuda_runtime.h>

#include "chol_blocked.cuh"

namespace {

constexpr int kWarpsPerCta = 4;
// per warp: Lc (32 x 32, 16-byte aligned), the tile (32 x 33), dinv (32)
constexpr int kWarpElems = 32 * 32 + 32 * 33 + 32;

// c <= 32: one warp per block.  The block is staged through the warp's
// tile with all of its loads in flight at once, factored and inverted in
// place, and written back row by row.
template <typename T>
__global__ void __launch_bounds__(kWarpsPerCta * 32)
    chol_inverse_warp_kernel(const T* __restrict__ D, T* __restrict__ L,
                             T* __restrict__ Linv, int P, int c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long blk =
      static_cast<long long>(blockIdx.x) * kWarpsPerCta + warp;
  if (blk >= P) {
    return;  // no block barrier follows: the warp's neighbours go on
  }
  T* Lc = reinterpret_cast<T*>(smem_raw) + warp * kWarpElems;
  T* S = Lc + 32 * 32;
  T* dg = S + 32 * 33;
  const size_t base = static_cast<size_t>(blk) * c * c;
  const T* Dp = D + base;

  pbt::load_block<T, 8>(S, 33, Dp, c, lane, 32);
  __syncwarp();
  pbt::warp_chol_inverse(S, 33, c, Lc, dg);

  T* Lp = L + base;
  T* Ip = Linv + base;
  if (lane < c) {
#pragma unroll 4
    for (int i = 0; i < c; ++i) {
      const T l = S[i * 33 + lane];
      const T li = S[lane * 33 + i];
      const T d = dg[i];
      Lp[i * c + lane] = lane <= i ? l : T(0);
      Ip[i * c + lane] = lane < i ? li : (lane == i ? d : T(0));
    }
  }
}

// 32 < c <= 128: one thread block of 256 threads per block, the blocked
// design of chol_blocked.cuh on a tile with odd row stride c | 1.
template <typename T>
__global__ void __launch_bounds__(pbt::kBlockedThreads)
    chol_inverse_blocked_kernel(const T* __restrict__ D, T* __restrict__ L,
                                T* __restrict__ Linv, int c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Lc = reinterpret_cast<T*>(smem_raw);
  T* Ut = Lc + pbt::kPanel * pbt::kPanel;
  T* A = Ut + pbt::kPanel * pbt::kUt;
  const int ld = c | 1;
  T* dg = A + c * ld;
  T* Ts = dg + c;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t base = static_cast<size_t>(blockIdx.x) * c * c;
  const T* Dp = D + base;

  pbt::load_block<T, 16>(A, ld, Dp, c, threadIdx.x, pbt::kBlockedThreads);
  __syncthreads();

  if (warp == 0) {
    pbt::warp_chol_inverse(A, ld, pbt::kPanel, Lc, dg);
  }
  __syncthreads();
  for (int j0 = 0; j0 + pbt::kPanel < c; j0 += pbt::kPanel) {
    pbt::panel_trsm(A, ld, j0, c - j0 - pbt::kPanel, dg, Ut);
    __syncthreads();
    pbt::update_and_next_panel(A, ld, c, j0, Ut, Lc, dg);
    __syncthreads();
  }
  pbt::block_inverse(A, ld, c, dg, Ts);

  T* Lp = L + base;
  T* Ip = Linv + base;
#pragma unroll 2
  for (int i = warp; i < c; i += pbt::kBlockedWarps) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {  // c <= 128: four lanes' columns a row
      const int j = lane + 32 * t;
      if (j < c) {
        const T l = A[i * ld + j];
        const T li = A[j * ld + i];
        Lp[i * c + j] = j <= i ? l : T(0);
        Ip[i * c + j] = j < i ? li : (j == i ? dg[i] : T(0));
      }
    }
  }
}

template <typename T>
int launch(const T* D, T* L, T* Linv, int P, int c, void* stream) {
  if (P <= 0) {
    return 0;
  }
  if (c < 1 || c > 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c <= 32) {
    const size_t smem = kWarpsPerCta * kWarpElems * sizeof(T);
    cudaError_t err = cudaFuncSetAttribute(
        chol_inverse_warp_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
    const int grid = (P + kWarpsPerCta - 1) / kWarpsPerCta;
    chol_inverse_warp_kernel<T><<<grid, kWarpsPerCta * 32, smem, s>>>(
        D, L, Linv, P, c);
  } else {
    const size_t smem = pbt::blocked_smem_elems(c) * sizeof(T);
    cudaError_t err = cudaFuncSetAttribute(
        chol_inverse_blocked_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
    chol_inverse_blocked_kernel<T><<<P, pbt::kBlockedThreads, smem, s>>>(
        D, L, Linv, c);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pbt_chol_inverse_f32(const float* D, float* L, float* Linv,
                                    int P, int c, void* stream) {
  return launch<float>(D, L, Linv, P, c, stream);
}

extern "C" int pbt_chol_inverse_f64(const double* D, double* L,
                                    double* Linv, int P, int c,
                                    void* stream) {
  return launch<double>(D, L, Linv, P, c, stream);
}
