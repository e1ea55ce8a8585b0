// Shared device code of the Cholesky + inverse chain, for Hopper (sm_90a).
//
// One thread block factors one (c, c) masked-SPD block held in shared
// memory with row stride ld = c + 1 (so column walks do not hit one bank).
// Only the lower triangle is read as the matrix.  After chol_chain_factor
// and chol_chain_inverse the tile holds
//   lower triangle, diagonal included:  L, with L L^T = D;
//   strict upper triangle:              Linv^T (A[j][i] = Linv[i][j], i > j),
// and Linv[j][j] = 1 / A[j][j].  That layout is the diag block the finalize
// stores (L below, Linv^T above), so the fused finalize kernel
// (finalize_fused.cu) writes its top rows straight from the tile.
//
// Users: chol_inverse.cu (K1) and finalize_fused.cu (K2).
//
// Numerics: IEEE arithmetic on the CUDA cores.  A non-positive pivot gives
// NaN (or inf) through sqrt and the division; nothing is clamped.  An
// identity block comes out exactly as identity ((0 - s) / l_ii keeps the
// zeros positive).
#pragma once

#include <cuda_runtime.h>

namespace pbt {

// Right-looking Cholesky on the lower triangle, column by column: the
// pivot column is scaled, then the trailing lower triangle takes the
// rank-1 update.  Two block-wide barriers per column; ends synchronized.
template <typename T>
__device__ __forceinline__ void chol_chain_factor(T* A, int c, int ld) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int k = 0; k < c; ++k) {
    const T d = sqrt(A[k * ld + k]);
    for (int i = k + 1 + tid; i < c; i += nt) {
      A[i * ld + k] = A[i * ld + k] / d;
    }
    __syncthreads();
    if (tid == 0) {
      A[k * ld + k] = d;
    }
    const int m = c - k - 1;
    for (int e = tid; e < m * m; e += nt) {
      const int i = k + 1 + e / m;
      const int j = k + 1 + e % m;
      if (j <= i) {
        A[i * ld + j] -= A[i * ld + k] * A[j * ld + k];
      }
    }
    __syncthreads();
  }
}

// Forward substitution for Linv, one thread per column j:
// x_j = 1 / L_jj, x_i = -(sum_{k=j}^{i-1} L_ik x_k) / L_ii for i > j, with
// x_i (i > j) stored at A[j][i].  A thread reads only lower-triangle L
// values and its own row of the strict upper triangle, so no slot is
// shared between threads.  Ends synchronized.
template <typename T>
__device__ __forceinline__ void chol_chain_inverse(T* A, int c, int ld) {
  for (int j = threadIdx.x; j < c; j += blockDim.x) {
    const T xj = T(1) / A[j * ld + j];
    for (int i = j + 1; i < c; ++i) {
      T s = A[i * ld + j] * xj;
      for (int k = j + 1; k < i; ++k) {
        s += A[i * ld + k] * A[j * ld + k];
      }
      A[j * ld + i] = (T(0) - s) / A[i * ld + i];
    }
  }
  __syncthreads();
}

}  // namespace pbt
