// Batched masked-SPD Cholesky with triangular inverse, for Hopper (sm_90a).
//
// Replaces the TPU kernel pallas_kernels.cholesky_inverse_pallas
// (parsy_bench_tpu/ops/pallas_kernels.py).  For each of P blocks D (c, c),
// row-major and contiguous, it writes the lower-triangular L with
// L L^T = D and Linv = L^{-1}; both have exact zeros above the diagonal.
// Only the lower triangle of D is read as the matrix.  Plain version and
// oracle: parsy_bench_tpu_torch/ops/dense.py cholesky_inverse.
//
// Design: one thread block per (c, c) block, held in shared memory with a
// padded row stride (c + 1) so that column walks do not hit one bank.
//   1. right-looking Cholesky, column by column: the pivot column is
//      scaled, then the trailing lower triangle takes the rank-1 update;
//   2. forward substitution for Linv, one thread per column.  Column j of
//      Linv is kept transposed in row j of the (dead) strict upper
//      triangle, so no second buffer is needed and no thread reads a slot
//      another thread writes;
//   3. a coalesced write of L and Linv.
// Steps 1 and 2 are the shared chain of chol_chain.cuh.
// The TPU kernel's Neumann-product inverse was a workaround for serialized
// triangular solves there; this card runs the substitution directly.
//
// What bounds it on this card: the c-long dependent pivot chain, with two
// block-wide barriers per column, and the c-long serial substitution of
// the first columns -- not bytes (each block is read once and written
// twice).  At c = 32 a 128-thread block does at most a few updates per
// thread between barriers.  Faster designs are later work: several blocks
// per CTA (one warp each, warp-synchronous) at c = 32, and a blocked panel
// update at c = 128.
//
// Numerics: IEEE arithmetic on the CUDA cores (no tensor cores, so no
// TF32).  A non-positive pivot gives NaN (or inf) through sqrt and the
// division; nothing is clamped.  An identity block comes out exactly as
// identity.

#include <cuda_runtime.h>

#include "chol_chain.cuh"

namespace {

template <typename T>
__global__ void chol_inverse_kernel(const T* __restrict__ D,
                                    T* __restrict__ L,
                                    T* __restrict__ Linv, int c) {
  extern __shared__ unsigned char smem_raw[];
  T* A = reinterpret_cast<T*>(smem_raw);
  const int ld = c + 1;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * c * c;
  const T* Dp = D + base;

  for (int e = tid; e < c * c; e += nt) {
    A[(e / c) * ld + (e % c)] = Dp[e];
  }
  __syncthreads();

  // 1-2. Cholesky on the lower triangle, Linv^T in the strict upper one.
  pbt::chol_chain_factor(A, c, ld);
  pbt::chol_chain_inverse(A, c, ld);

  // 3. Write out, zero above the diagonal.
  T* Lp = L + base;
  T* Ip = Linv + base;
  for (int e = tid; e < c * c; e += nt) {
    const int i = e / c;
    const int j = e % c;
    Lp[e] = j <= i ? A[i * ld + j] : T(0);
    Ip[e] = j < i ? A[j * ld + i]
                  : (j == i ? T(1) / A[i * ld + i] : T(0));
  }
}

template <typename T>
int launch(const T* D, T* L, T* Linv, int P, int c, void* stream) {
  if (P <= 0) {
    return 0;
  }
  const int threads = c >= 64 ? 256 : 128;
  const size_t smem = static_cast<size_t>(c) * (c + 1) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      chol_inverse_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  chol_inverse_kernel<T><<<P, threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(D, L, Linv,
                                                                c);
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
