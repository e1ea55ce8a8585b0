// Device code of the Cholesky + inverse for Hopper (sm_90a): a one-warp
// routine for blocks of width <= 32, and the blocked routine built on it
// for widths up to 128.  Used by chol_inverse.cu (K1) and
// finalize_fused.cu (K2).
//
// Storage, shared by both routines: a (c, c) block in shared memory with
// an odd row stride, of which only the lower triangle is read as the
// matrix.  Afterwards it holds
//   lower triangle, diagonal included:  L, with L L^T = D;
//   strict upper triangle:              Linv^T (S[j][i] = Linv[i][j], i > j),
// and dinv[i] = Linv[i][i].
//
// Numerics: FMAs on the CUDA cores (no tensor cores, so no TF32).  Each
// pivot p is taken through rsqrt(p) (within 2 ulp in f32, 1 in f64):
// L[k][k] = p rsqrt(p) and the column is scaled by rsqrt(p), a few ulp
// from the plain version's sqrt and division.  A non-positive pivot gives
// NaN (or inf) through rsqrt; nothing is clamped.  An identity block comes
// out exactly as identity: rsqrt(1) = 1, and every update it takes is a
// product with an exact zero.
#pragma once

#include <cuda_runtime.h>

namespace pbt {

constexpr unsigned kFullMask = 0xffffffffu;

// 16 bytes of shared memory as T values (float4 or double2 loads).
template <typename T>
__device__ __forceinline__ void load16(const T* p, T (&out)[16 / sizeof(T)]) {
  if constexpr (sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else {
    const double2 v = *reinterpret_cast<const double2*>(p);
    out[0] = v.x;
    out[1] = v.y;
  }
}

// One warp factors and inverts one (n, n) block, n <= 32, at S (row
// stride lds, odd), in the storage above; dinv has n slots.  Lc is the
// warp's 32 x 32 scratch, 16-byte aligned: column k of L, contiguous.
//
// The block is taken as 32 x 32 with identity beyond n, so every loop is
// unrolled at compile time and the rows live in registers.  Lane i owns
// row i of the matrix (r) and column i of Linv (x).  Step k:
//   1. the pivot p comes from lane k by a shuffle; inv = rsqrt(p) and
//      d = p inv = L[k][k];
//   2. lane i > k forms L[i][k] = r[k] * inv and writes it to column k of
//      Lc; every lane takes the substitution step of its Linv column,
//      x[k] = (e_i[k] - x[k]) * inv;
//   3. after one __syncwarp every lane reads column k as 16-byte
//      broadcasts and updates r[j] -= L[i][k] L[j][k] and
//      x[j] += L[j][k] x[k] (j > k).
// The next pivot is formed in step 2 from the lane's own L[k+1][k]
// (r[k+1] - v^2), so the dependent chain per step is a shuffle, an rsqrt
// and two FMAs; the shared-memory round trip runs beside it.  No block
// barrier, no integer division.  Ends with the warp synchronized.
//
// kStopAtN: leave the loop after step n - 1.  The steps past n change
// nothing in the first n rows and columns (their pivots are 1 and their
// columns below the diagonal 0), so the result is the same; K2 sets it,
// since most of its lanes are far narrower than 32.
template <typename T, bool kStopAtN = false>
__device__ __forceinline__ void warp_chol_inverse(T* S, int lds, int n,
                                                  T* Lc, T* dinv) {
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  T r[32];
  T x[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    T v = T(0);
    if (lane < n && j <= lane) {
      v = S[lane * lds + j];
    } else if (j == lane) {
      v = T(1);
    }
    r[j] = v;
    x[j] = T(0);
  }

  T p = r[0];  // this lane's candidate for the next pivot
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    if (kStopAtN && k >= n) {
      break;  // n is the same in every lane
    }
    const T piv = __shfl_sync(kFullMask, p, k);
    const T inv = rsqrt(piv);
    const T d = piv * inv;
    const T v = lane > k ? r[k] * inv : T(0);
    if (k + 1 < 32) {
      p = fma(-v, v, r[k + 1]);
    }
    r[k] = lane == k ? d : v;
    x[k] = ((lane == k ? T(1) : T(0)) - x[k]) * inv;
    Lc[k * 32 + lane] = v;
    __syncwarp();
#pragma unroll
    for (int j0 = 0; j0 < 32; j0 += V) {
      if (j0 + V - 1 > k) {
        T col[V];
        load16(Lc + k * 32 + j0, col);
#pragma unroll
        for (int t = 0; t < V; ++t) {
          if (j0 + t > k) {
            r[j0 + t] = fma(-v, col[t], r[j0 + t]);
            x[j0 + t] = fma(col[t], x[k], x[j0 + t]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (lane < n && j <= lane) {
      S[lane * lds + j] = r[j];
    }
    if (lane < n && j > lane && j < n) {
      S[lane * lds + j] = x[j];
    }
    if (lane == j && j < n) {
      dinv[j] = x[j];
    }
  }
  __syncwarp();
}

// All threads of a CTA (nt of them, this one tid) copy a contiguous
// (c, c) block from device memory into the tile A (row stride ld), with
// kChunk independent loads in flight per thread before any store: 16-byte
// loads where the rows allow them, else single elements.
template <typename T, int kChunk>
__device__ __forceinline__ void load_block(T* A, int ld,
                                           const T* __restrict__ Dp, int c,
                                           int tid, int nt) {
  constexpr int V = 16 / sizeof(T);
  const int total = c * c;
  if (c % V == 0 && reinterpret_cast<size_t>(Dp) % 16 == 0) {
    const int nvec = total / V;
    for (int e0 = tid; e0 < nvec; e0 += kChunk * nt) {
      T v[kChunk][V];
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        const int e = e0 + t * nt;
        if (e < nvec) {
          load16(Dp + e * V, v[t]);
        }
      }
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        const int e = (e0 + t * nt) * V;
        if (e < total) {
          const int i = e / c;
#pragma unroll
          for (int u = 0; u < V; ++u) {
            A[i * ld + e - i * c + u] = v[t][u];
          }
        }
      }
    }
    return;
  }
  for (int e0 = tid; e0 < total; e0 += kChunk * nt) {
    T v[kChunk];
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      const int e = e0 + t * nt;
      v[t] = e < total ? Dp[e] : T(0);
    }
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      const int e = e0 + t * nt;
      if (e < total) {
        const int i = e / c;
        A[i * ld + e - i * c] = v[t];
      }
    }
  }
}

// Threads of the blocked routine, and its thread grid for the block
// substitution: a 16 x 16 grid, thread (ty, tx) owning rows ty + 16a and
// columns tx + 16b of each 32 x 32 block.
constexpr int kBlockedThreads = 256;
constexpr int kBlockedWarps = kBlockedThreads / 32;
constexpr int kPanel = 32;
// row stride of Ut, the panel's L21 transposed: the 96 rows below the
// first panel at c = 128, plus 4 (16-byte aligned rows; lane q's column
// writes fall on 8 banks)
constexpr int kUt = 3 * kPanel + 4;

// Shared-memory elements the blocked routine needs at width c (the
// 16-byte-aligned Lc and Ut scratch first, then the tile, dinv and Ts).
__host__ __device__ inline int blocked_smem_elems(int c) {
  const int np = (c + kPanel - 1) / kPanel;
  return kPanel * kPanel + kPanel * kUt + c * (c | 1) + c +
         (np - 1) * kPanel * (kPanel + 1);
}

// The panel routines below run only for panels with rows below them, and
// those are kPanel wide.  Their shared-memory loads are unconditional (in
// bounds of the tile, with rows clamped where a strip runs past the
// block) and selected afterwards, so the compiler can issue them ahead of
// the FMAs that use them.

// Panel TRSM as a product with the panel's inverse (the TPU kernel's
// TRSM-as-GEMM): L21 = A21 Linv11^T, written in place and, transposed,
// into Ut (Ut[q][i] = L21[i][q], row stride kUt) for the trailing update.
// Warps take rows, two at a time; lane j keeps row j of Linv11 in
// registers and reads A21's rows as broadcasts.
template <typename T>
__device__ __forceinline__ void panel_trsm(T* A, int ld, int j0, int m,
                                           const T* dg, T* Ut) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j1 = j0 + kPanel;
  const T dl = dg[j0 + lane];
  T lin[kPanel];
#pragma unroll
  for (int k = 0; k < kPanel; ++k) {
    const T t = A[(j0 + k) * ld + j0 + lane];
    lin[k] = k < lane ? t : (k == lane ? dl : T(0));
  }
  for (int i = warp; i < m; i += 2 * kBlockedWarps) {
    const int i2 = i + kBlockedWarps;
    const bool two = i2 < m;
    const T* row = A + (j1 + i) * ld + j0;
    const T* row2 = A + (j1 + (two ? i2 : i)) * ld + j0;
    T acc = T(0);
    T acc2 = T(0);
#pragma unroll
    for (int k = 0; k < kPanel; ++k) {
      acc = fma(row[k], lin[k], acc);
      acc2 = fma(row2[k], lin[k], acc2);
    }
    __syncwarp();  // the rows are read before any lane writes them
    A[(j1 + i) * ld + j0 + lane] = acc;
    Ut[lane * kUt + i] = acc;
    if (two) {
      A[(j1 + i2) * ld + j0 + lane] = acc2;
      Ut[lane * kUt + i2] = acc2;
    }
  }
}

// One warp applies the trailing update of the panel whose L21 is in Ut
// (first row j1 of the tile) to one 32 x 32 block of A22, rows I0 and
// columns J0 of the tile (hi x hj valid, lower triangle only where
// I0 = J0): A[I0 + i][J0 + j] -= sum_q L21[I0 - j1 + i][q] L21[J0 - j1 + j][q].
// Lane j owns column j and accumulates all 32 rows; its own Ut value is
// one load, the rows' come as 16-byte broadcasts.  Rows and columns past
// the block read Ut's padding: in bounds, unused.
template <typename T>
__device__ __forceinline__ void block_update(T* A, int ld, const T* Ut,
                                             int j1, int I0, int J0, int hi,
                                             int hj) {
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  T acc[kPanel];
#pragma unroll
  for (int i = 0; i < kPanel; ++i) {
    acc[i] = T(0);
  }
#pragma unroll 2
  for (int q = 0; q < kPanel; ++q) {
    const T* U = Ut + q * kUt;
    const T own = U[J0 - j1 + lane];
#pragma unroll
    for (int i0 = 0; i0 < kPanel; i0 += V) {
      T row[V];
      load16(U + I0 - j1 + i0, row);
#pragma unroll
      for (int t = 0; t < V; ++t) {
        acc[i0 + t] = fma(row[t], own, acc[i0 + t]);
      }
    }
  }
  // read every row first (rows past hi clamped into the block), so the
  // loads need not wait on the stores' conditions
  T old[kPanel];
#pragma unroll
  for (int i = 0; i < kPanel; ++i) {
    old[i] = A[(I0 + min(i, hi - 1)) * ld + J0 + lane];
  }
  if (lane < hj) {
#pragma unroll
    for (int i = 0; i < kPanel; ++i) {
      if (i < hi && (I0 != J0 || lane <= i)) {
        A[(I0 + i) * ld + J0 + lane] = old[i] - acc[i];
      }
    }
  }
}

// The trailing update of panel j0 (rows below it, m of them), with the
// next panel's factorization in it (look-ahead): warp 0 updates the next
// diagonal block and factors and inverts it at once, while warps 1-7
// update the 32 x 32 blocks of A22 below it.
template <typename T>
__device__ __forceinline__ void update_and_next_panel(T* A, int ld, int c,
                                                      int j0, const T* Ut,
                                                      T* Lc, T* dg) {
  const int warp = threadIdx.x >> 5;
  const int j1 = j0 + kPanel;
  const int pw1 = min(kPanel, c - j1);
  if (warp == 0) {
    block_update(A, ld, Ut, j1, j1, j1, pw1, pw1);
    __syncwarp();
    warp_chol_inverse(A + j1 * ld + j1, ld, pw1, Lc, dg + j1);
    return;
  }
  int idx = 0;
  for (int I0 = j1 + kPanel; I0 < c; I0 += kPanel) {
    for (int J0 = j1; J0 <= I0; J0 += kPanel) {
      if (idx % (kBlockedWarps - 1) == warp - 1) {
        block_update(A, ld, Ut, j1, I0, J0, min(kPanel, c - I0),
                     min(kPanel, c - J0));
      }
      ++idx;
    }
  }
}

// Linv by block forward substitution, one 32-row block row after another:
//   Linv_IJ = -Linv_II sum_{K=J}^{I-1} L_IK Linv_KJ   (J < I),
// the sum into Ts (one 32 x 33 slice per J), then the product with the
// diagonal block's inverse, written transposed into the upper block
// (J, I).  The sum runs K-outer, so each L_IK
// value a thread loads serves every J <= K.  The block loops are unrolled
// (at most kMaxPanels panels), so the accumulators stay in registers.
// Two barriers per block row.
constexpr int kMaxPanels = 4;

template <typename T>
__device__ __forceinline__ void block_inverse(T* A, int ld, int c,
                                              const T* dg, T* Ts) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  constexpr int kTs = kPanel * (kPanel + 1);
  const int np = (c + kPanel - 1) / kPanel;
#pragma unroll
  for (int bi = 1; bi < kMaxPanels; ++bi) {
    if (bi >= np) {
      break;
    }
    const int I0 = kPanel * bi;
    const int pwi = min(kPanel, c - I0);
    // rows of this thread, clamped into the block row (results of a
    // clamped row are never read)
    const int r0 = min(ty, pwi - 1);
    const int r1 = min(ty + 16, pwi - 1);
    T acc[kMaxPanels - 1][2][2];
#pragma unroll
    for (int bj = 0; bj < bi; ++bj) {
      acc[bj][0][0] = acc[bj][0][1] = acc[bj][1][0] = acc[bj][1][1] = T(0);
    }
    // Ts[J] = sum_K L_IK Linv_KJ; Linv_KJ is read from the upper block
    // (J, K), or for K = J from the diagonal block's strict upper and dg
#pragma unroll
    for (int bk = 0; bk < bi; ++bk) {
      const int K0 = kPanel * bk;
      const T dk0 = dg[K0 + tx];
      const T dk1 = dg[K0 + tx + 16];
#pragma unroll 4
      for (int q = 0; q < kPanel; ++q) {
        const T l0 = A[(I0 + r0) * ld + K0 + q];
        const T l1 = A[(I0 + r1) * ld + K0 + q];
#pragma unroll
        for (int bj = 0; bj <= bk; ++bj) {
          const int J0 = kPanel * bj;
          T i0 = A[(J0 + tx) * ld + K0 + q];
          T i1 = A[(J0 + tx + 16) * ld + K0 + q];
          if (bj == bk) {
            i0 = q > tx ? i0 : (q == tx ? dk0 : T(0));
            i1 = q > tx + 16 ? i1 : (q == tx + 16 ? dk1 : T(0));
          }
          acc[bj][0][0] = fma(l0, i0, acc[bj][0][0]);
          acc[bj][0][1] = fma(l0, i1, acc[bj][0][1]);
          acc[bj][1][0] = fma(l1, i0, acc[bj][1][0]);
          acc[bj][1][1] = fma(l1, i1, acc[bj][1][1]);
        }
      }
    }
#pragma unroll
    for (int bj = 0; bj < bi; ++bj) {
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          Ts[bj * kTs + (ty + 16 * a) * (kPanel + 1) + tx + 16 * b] =
              acc[bj][a][b];
        }
      }
    }
    __syncthreads();
    // Linv_IJ = -Linv_II Ts[J]; Linv_II is the diagonal block's strict
    // upper (transposed) and dg
    const T di0 = dg[I0 + r0];
    const T di1 = dg[I0 + r1];
#pragma unroll
    for (int bj = 0; bj < bi; ++bj) {
      acc[bj][0][0] = acc[bj][0][1] = acc[bj][1][0] = acc[bj][1][1] = T(0);
    }
#pragma unroll 4
    for (int q = 0; q < pwi; ++q) {
      T l0 = A[(I0 + q) * ld + I0 + r0];
      T l1 = A[(I0 + q) * ld + I0 + r1];
      l0 = q < r0 ? l0 : (q == r0 ? di0 : T(0));
      l1 = q < r1 ? l1 : (q == r1 ? di1 : T(0));
#pragma unroll
      for (int bj = 0; bj < bi; ++bj) {
        const T* Tj = Ts + bj * kTs + q * (kPanel + 1);
        const T t0 = Tj[tx];
        const T t1 = Tj[tx + 16];
        acc[bj][0][0] = fma(l0, t0, acc[bj][0][0]);
        acc[bj][0][1] = fma(l0, t1, acc[bj][0][1]);
        acc[bj][1][0] = fma(l1, t0, acc[bj][1][0]);
        acc[bj][1][1] = fma(l1, t1, acc[bj][1][1]);
      }
    }
#pragma unroll
    for (int bj = 0; bj < bi; ++bj) {
      const int J0 = kPanel * bj;
      if (ty < pwi) {
        A[(J0 + tx) * ld + I0 + ty] = -acc[bj][0][0];
        A[(J0 + tx + 16) * ld + I0 + ty] = -acc[bj][0][1];
      }
      if (ty + 16 < pwi) {
        A[(J0 + tx) * ld + I0 + ty + 16] = -acc[bj][1][0];
        A[(J0 + tx + 16) * ld + I0 + ty + 16] = -acc[bj][1][1];
      }
    }
    __syncthreads();
  }
}

}  // namespace pbt
