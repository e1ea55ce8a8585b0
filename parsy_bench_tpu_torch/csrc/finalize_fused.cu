// Fused per-bucket finalize, for Hopper (sm_90a): K2.
//
// Replaces the TPU kernel pallas_kernels.finalize_fused_pallas
// (parsy_bench_tpu/ops/pallas_kernels.py, body _finalize_body).  For one
// finalize bucket blk (P, H, c), row-major and contiguous, with logical
// widths w (P,) int32 and a true lane count cnt, it writes
//   diff = out - blk on lanes p < cnt, 0 on lanes p >= cnt,
// where, with D = masked_spd(blk[p, :c, :], w[p]) = L L^T and Linv = L^{-1},
//   out[i, :] = Ltop[i, :]          for i < w   (L below the diagonal,
//                                                Linv^T above, on the
//                                                valid w x w part, else 0)
//   out[i, j] = (blk Linv^T)[i, j]  for i >= w, j < w  (the panel TRSM)
//   out[i, j] = 0                   for i >= w, j >= w.
// Plain version and oracle: parsy_bench_tpu_torch/ops/dense.py
// finalize_fused.  The executor adds diff onto its window.
//
// Design: a 2-D grid of (lane, chunk of rows).  Every block of a lane
// below cnt
//   1. builds the masked-SPD lower triangle of the lane's top c x c in
//      shared memory (row stride c + 1) and runs the shared Cholesky +
//      inverse chain (chol_chain.cuh).  The tile then holds L below and
//      Linv^T above the diagonal: it is Ltop before masking;
//   2. streams its rows of blk through a 32-row shared tile and computes
//      Y[h, j] = sum_{k <= j} blk[h, k] Linv[j, k] with Linv[j, k] read from
//      the tile's strict upper triangle and Linv[j, j] = 1 / L_jj; the
//      whole block is never held.
// Tall buckets (at laplace_3d(48) as tall as H = 4,096 at P = 1) are split
// into chunks so that about two waves of blocks fill the 132 SMs; each
// chunk recomputes the lane's c x c chain (about one K1 block of work) and
// writes only its own rows.  Lanes at or beyond cnt write zeros and run no
// chain.
//
// What bounds it on this card: at the leaf bucket (27,456 x 32 x 32) the
// c-long dependent pivot chain with its two barriers per column, as in K1
// (bytes: 112 MB in and out); at the tall buckets the chain's latency plus
// the Y product on the few SMs the chunks occupy.
//
// Numerics: IEEE FMAs on the CUDA cores (no tensor cores, so no TF32).  A
// non-positive pivot gives NaN, as in K1.  1 <= c <= 128 and H >= c.

#include <cuda_runtime.h>

#include "chol_chain.cuh"

namespace {

// rows of blk staged in shared memory at a time
constexpr int kRowTile = 32;

template <typename T>
__global__ void finalize_fused_kernel(const T* __restrict__ blk,
                                      const int* __restrict__ w,
                                      T* __restrict__ diff, int H, int c,
                                      int cnt, int chunk) {
  const int p = blockIdx.x;
  const int r0 = blockIdx.y * chunk;
  const int r1 = min(H, r0 + chunk);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t base = static_cast<size_t>(p) * H * c;
  const T* B = blk + base;
  T* O = diff + base;
  if (r0 >= r1) {
    return;
  }
  if (p >= cnt) {
    for (int e = r0 * c + tid; e < r1 * c; e += nt) {
      O[e] = T(0);
    }
    return;
  }

  extern __shared__ unsigned char smem_raw[];
  T* A = reinterpret_cast<T*>(smem_raw);
  const int ld = c + 1;
  T* dinv = A + c * ld;      // (c,)   1 / L_jj
  T* S = dinv + c;           // (kRowTile, ld) staged rows of blk
  // widths outside [0, c] act as the nearest end, as in the plain version
  const int wl = max(0, min(w[p], c));

  // 1. masked_spd on the lower triangle: the valid part of blk, identity
  //    on the padded diagonal, zero elsewhere (j <= i < wl implies j < wl)
  for (int e = tid; e < c * c; e += nt) {
    const int i = e / c;
    const int j = e % c;
    if (j <= i) {
      A[i * ld + j] = i < wl ? B[e] : (i == j ? T(1) : T(0));
    }
  }
  __syncthreads();
  pbt::chol_chain_factor(A, c, ld);
  pbt::chol_chain_inverse(A, c, ld);
  for (int j = tid; j < c; j += nt) {
    dinv[j] = T(1) / A[j * ld + j];
  }
  __syncthreads();

  // 2. this chunk's rows, kRowTile at a time
  for (int t0 = r0; t0 < r1; t0 += kRowTile) {
    const int nr = min(kRowTile, r1 - t0);
    const T* Bt = B + static_cast<size_t>(t0) * c;
    for (int e = tid; e < nr * c; e += nt) {
      S[(e / c) * ld + e % c] = Bt[e];
    }
    __syncthreads();
    T* Ot = O + static_cast<size_t>(t0) * c;
    for (int e = tid; e < nr * c; e += nt) {
      const int hl = e / c;
      const int j = e % c;
      const int h = t0 + hl;
      T out = T(0);
      if (h < wl) {
        // a top row of the valid part: L at j <= h, Linv^T at j > h
        if (j < wl) {
          out = A[h * ld + j];
        }
      } else if (j < wl) {
        T s = S[hl * ld + j] * dinv[j];
        for (int k = 0; k < j; ++k) {
          s += S[hl * ld + k] * A[k * ld + j];
        }
        out = s;
      }
      Ot[e] = out - S[hl * ld + j];
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const T* blk, const int* w, T* diff, int P, int H, int c,
           int cnt, int nchunk, void* stream) {
  if (P <= 0 || H <= 0) {
    return 0;
  }
  const int threads = c >= 64 ? 256 : 128;
  const int chunk = (H + nchunk - 1) / nchunk;
  const size_t smem = (static_cast<size_t>(c) * (c + 1) + c
                       + static_cast<size_t>(kRowTile) * (c + 1))
                      * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      finalize_fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const dim3 grid(P, nchunk);
  finalize_fused_kernel<T><<<grid, threads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      blk, w, diff, H, c, cnt, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pbt_finalize_fused_f32(const float* blk, const int* w,
                                      float* diff, int P, int H, int c,
                                      int cnt, int nchunk, void* stream) {
  return launch<float>(blk, w, diff, P, H, c, cnt, nchunk, stream);
}

extern "C" int pbt_finalize_fused_f64(const double* blk, const int* w,
                                      double* diff, int P, int H, int c,
                                      int cnt, int nchunk, void* stream) {
  return launch<double>(blk, w, diff, P, H, c, cnt, nchunk, stream);
}
