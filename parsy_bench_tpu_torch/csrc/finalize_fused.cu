// Fused per-bucket finalize, for Hopper (sm_90a): K2.
//
// Replaces the TPU kernel pallas_kernels.finalize_fused_pallas
// (parsy_bench_tpu/ops/pallas_kernels.py, body _finalize_body).  For one
// finalize bucket blk (P, H, c), row-major and contiguous, with logical
// widths w (P,) int32 and a true lane count cnt, it writes
//   diff = out - blk on lanes p < cnt, 0 on lanes p >= cnt (read nothing),
// where, with wl = w[p] clamped to [0, c], D = masked_spd(blk[p, :c, :], wl)
// = L L^T and Linv = L^{-1},
//   out[i, :] = Ltop[i, :]          for i < wl  (L below the diagonal,
//                                                Linv^T above, on the
//                                                valid wl x wl part, else 0)
//   out[i, j] = (blk Linv^T)[i, j]  for i >= wl, j < wl  (the panel TRSM)
//   out[i, j] = 0                   for i >= wl, j >= wl.
// So a lane with wl = 0 gives exactly -blk.  Plain version and oracle:
// parsy_bench_tpu_torch/ops/dense.py finalize_fused.  The executor adds
// diff onto its window.  1 <= c <= 128, H >= c.
//
// The Cholesky + inverse is K1's (chol_blocked.cuh): masked_spd at width
// wl is the block taken as identity beyond wl, which is what the routines
// do with rows and columns past their width, so the mask costs nothing.
// The grid is cut into units of (lane, chunk of rows); every unit factors
// its lane's top again and writes only its own rows.  The wrapper
// (ops/kernels.py finalize_fused_cuda) sizes the chunks so that tall,
// narrow buckets (at laplace_3d(48) up to H = 4,096 at P = 1) fill the
// card.
//
// What bounds it on this card, and what the design does about each:
//   c <= 32 (every call at laplace_3d(48)): at the leaf bucket (27,456 x
//     32 x 32) bytes: blk read once and diff written once, 225 MB (0.067
//     ms at 3.35 TB/s).  As in K1's leaf, one warp owns one unit, four
//     warps a CTA, with no block barrier: the warp loads its top with all
//     32 rows in flight (coalesced, one row per load instruction), keeps
//     one copy for diff and one for the chain, runs warp_chol_inverse for
//     wl steps only, and holds row j of Linv in lane j's registers.  Each
//     output row is then wl FMAs per lane on 16-byte broadcasts of the
//     row from shared memory.  (Most leaf lanes there have wl = 1, so the
//     work per lane is far below the 32-wide block's.)  Rows below the top
//     stream through the warp, eight at a time, the next eight already
//     loading.  At the tall buckets (P <= 960) the chain's latency: one
//     warp chain per unit, rerun by every chunk, with the first rows'
//     loads issued before it.
//   32 < c <= 128 (FUSED_MAX_WIDTH = 64 classes, off this matrix's path):
//     one 256-thread CTA per unit runs K1's blocked sequence (diagonal
//     panel routine, panel TRSM, trailing update with look-ahead, block
//     inverse) on the masked top, then forms Y on 16-row stages, one
//     column a thread, rows split over the warps.  Correct and simple;
//     its rows' products read Linv from shared memory.
// No integer division in any loop.
//
// Numerics: FMAs on the CUDA cores (no tensor cores, so no TF32); pivots
// through rsqrt.  A non-positive pivot gives NaN (or inf); nothing is
// clamped.

#include <cuda_runtime.h>

#include "chol_blocked.cuh"

namespace {

// ---- c <= 32: one warp per unit ----------------------------------------

constexpr int kWarpsPerCta = 4;
// rows of a tall bucket a warp stages and multiplies at a time
constexpr int kRows = 8;
// row stride of the warp's copy of blk's rows: 16-byte aligned rows
template <typename T>
constexpr int kLdB = 32 + 16 / sizeof(T);
// per warp: Lc (32 x 32, 16-byte aligned), Bt (32 x kLdB: blk's top, then
// the staged rows), S (32 x 33: the chain's tile), dinv (32)
template <typename T>
constexpr int kWarpElems = 32 * 32 + 32 * kLdB<T> + 32 * 33 + 32;

// acc[t] = sum_{k < kmax} Bt[row0 + t][k] lin[k] for kRows rows of Bt
// (row index clamped to rowmax, so every load is in bounds and
// unconditional), the rows read as 16-byte broadcasts; kmax is the same
// in every lane, and lin[k] is zero for k >= kmax.
template <typename T>
__device__ __forceinline__ void row_products(const T* Bt, int row0,
                                             int rowmax, int kmax,
                                             const T (&lin)[32],
                                             T (&acc)[kRows]) {
  constexpr int V = 16 / sizeof(T);
  const T* rows[kRows];
#pragma unroll
  for (int t = 0; t < kRows; ++t) {
    rows[t] = Bt + min(row0 + t, rowmax) * kLdB<T>;
    acc[t] = T(0);
  }
#pragma unroll
  for (int k0 = 0; k0 < 32; k0 += V) {
    if (k0 >= kmax) {
      break;
    }
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      T v[V];
      pbt::load16(rows[t] + k0, v);
#pragma unroll
      for (int u = 0; u < V; ++u) {
        acc[t] = fma(v[u], lin[k0 + u], acc[t]);
      }
    }
  }
}

// Lane j's elements of kRows rows of blk from row h on (rows clamped to
// hmax, columns to c - 1; lanes at or beyond c get zeros): one coalesced
// row a load, all in flight.
template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ B, int h,
                                          int hmax, int c, int lane,
                                          T (&v)[kRows]) {
  const int j = min(lane, c - 1);
#pragma unroll
  for (int t = 0; t < kRows; ++t) {
    const T x = B[min(h + t, hmax) * c + j];
    v[t] = lane < c ? x : T(0);
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerCta * 32)
    finalize_warp_kernel(const T* __restrict__ blk,
                         const int* __restrict__ w, T* __restrict__ diff,
                         int units, int H, int c, int cnt, int nchunk,
                         int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int unit = blockIdx.x * kWarpsPerCta + warp;
  if (unit >= units) {
    return;  // no block barrier follows: the warp's neighbours go on
  }
  const int p = unit / nchunk;
  const int r0 = (unit - p * nchunk) * chunk;
  const int r1 = min(H, r0 + chunk);
  if (r0 >= r1) {
    return;
  }
  const size_t base = static_cast<size_t>(p) * H * c;
  const T* B = blk + base;
  T* O = diff + base;
  if (p >= cnt) {
    for (int e = r0 * c + lane; e < r1 * c; e += 32) {
      O[e] = T(0);
    }
    return;
  }
  T* Lc = reinterpret_cast<T*>(smem_raw) + warp * kWarpElems<T>;
  T* Bt = Lc + 32 * 32;
  T* S = Bt + 32 * kLdB<T>;
  T* dinv = S + 32 * 33;
  // widths outside [0, c] act as the nearest end, as in the plain version
  const int wl = max(0, min(w[p], c));
  const int jc = min(lane, c - 1);

  // 1. the top c x c, lane j holding column j: 32 loads in flight, then
  //    one copy kept for diff (zeros beyond c) and one for the chain
  {
    T v[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const T x = B[min(i, c - 1) * c + jc];
      v[i] = lane < c && i < c ? x : T(0);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      Bt[i * kLdB<T> + lane] = v[i];
      if (i < wl) {  // the chain reads the rows below wl only
        S[i * 33 + lane] = v[i];
      }
    }
  }
  // the first rows below the top start loading before the chain
  const int hs = max(r0, c);
  T v[kRows];
  if (hs < r1) {
    load_rows(B, hs, r1 - 1, c, lane, v);
  }
  __syncwarp();

  // 2. factor and invert the valid wl x wl part (identity beyond it):
  //    S then holds L below and Linv^T above its diagonal, dinv Linv's
  //    diagonal
  pbt::warp_chol_inverse<T, true>(S, 33, wl, Lc, dinv);

  // row j of Linv in lane j's registers (zero past the diagonal, and for
  // lanes at or beyond wl, whose columns of out are zero)
  T lin[32];
  {
    const T dl = dinv[lane];
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const T t = S[k * 33 + lane];
      lin[k] = lane < wl ? (k < lane ? t : (k == lane ? dl : T(0))) : T(0);
    }
  }

  // 3. this unit's top rows: Ltop straight from the tile below wl, the
  //    panel product Y from the kept copy of blk from wl to c
  const int ht = min(r1, wl);
#pragma unroll 4
  for (int h = r0; h < ht; ++h) {
    const T out = lane < wl ? S[h * 33 + lane] : T(0);
    if (lane < c) {
      O[h * c + lane] = out - Bt[h * kLdB<T> + lane];
    }
  }
  const int hy = min(r1, c);
  for (int h = max(r0, wl); h < hy; h += kRows) {
    T acc[kRows];
    row_products(Bt, h, hy - 1, wl, lin, acc);
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      if (h + t < hy && lane < c) {
        O[(h + t) * c + lane] = (lane < wl ? acc[t] : T(0)) -
                                Bt[(h + t) * kLdB<T> + lane];
      }
    }
  }

  // 4. the rows below the top, kRows at a time through Bt's first rows,
  //    the next kRows loading meanwhile
  for (int h = hs; h < r1; h += kRows) {
    __syncwarp();  // the last readers of the staged rows are done
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      Bt[t * kLdB<T> + lane] = v[t];
    }
    T vn[kRows];
    load_rows(B, min(h + kRows, r1 - 1), r1 - 1, c, lane, vn);
    __syncwarp();
    T acc[kRows];
    row_products(Bt, 0, kRows - 1, wl, lin, acc);
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      if (h + t < r1 && lane < c) {
        O[(h + t) * c + lane] = (lane < wl ? acc[t] : T(0)) - v[t];
      }
      v[t] = vn[t];
    }
  }
}

// ---- 32 < c <= 128: one CTA per unit, K1's blocked routine --------------

// rows of blk staged per step of the product
constexpr int kStageRows = 16;
// rows of the masked top each thread loads at once
constexpr int kLoadRows = 8;

template <typename T>
__global__ void __launch_bounds__(pbt::kBlockedThreads)
    finalize_blocked_kernel(const T* __restrict__ blk,
                            const int* __restrict__ w, T* __restrict__ diff,
                            int H, int c, int cnt, int nchunk, int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int p = blockIdx.x / nchunk;
  const int r0 = (blockIdx.x - p * nchunk) * chunk;
  const int r1 = min(H, r0 + chunk);
  if (r0 >= r1) {
    return;  // the whole CTA, before any barrier
  }
  const size_t base = static_cast<size_t>(p) * H * c;
  const T* B = blk + base;
  T* O = diff + base;
  if (p >= cnt) {
    for (int e = r0 * c + tid; e < r1 * c; e += pbt::kBlockedThreads) {
      O[e] = T(0);
    }
    return;
  }
  T* Lc = reinterpret_cast<T*>(smem_raw);
  T* Ut = Lc + pbt::kPanel * pbt::kPanel;
  T* A = Ut + pbt::kPanel * pbt::kUt;
  const int ld = c | 1;
  T* dg = A + c * ld;
  T* Ts = dg + c;
  T* St = reinterpret_cast<T*>(smem_raw) + pbt::blocked_smem_elems(c);
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wl = max(0, min(w[p], c));
  // thread (i0, j) moves column j of rows i0, i0 + 2, ... (c <= 128)
  const int j = tid & 127;
  const int i0 = tid >> 7;
  const int jc = min(j, c - 1);

  // 1. masked_spd's lower triangle in the tile: blk's rows below wl,
  //    identity beyond
  for (int i = i0; i < c; i += 2 * kLoadRows) {
    T v[kLoadRows];
#pragma unroll
    for (int t = 0; t < kLoadRows; ++t) {
      v[t] = B[min(i + 2 * t, c - 1) * c + jc];
    }
#pragma unroll
    for (int t = 0; t < kLoadRows; ++t) {
      const int r = i + 2 * t;
      if (r < c && j <= r) {
        A[r * ld + j] = r < wl ? v[t] : (r == j ? T(1) : T(0));
      }
    }
  }
  __syncthreads();

  // 2. K1's blocked Cholesky + inverse (chol_inverse.cu
  //    chol_inverse_blocked_kernel): A then holds L below and Linv^T
  //    above its diagonal, dg Linv's diagonal
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
  pbt::block_inverse(A, ld, c, dg, Ts);  // ends with a barrier (c > 32)

  // 3. the unit's rows, kStageRows at a time: warp (s, g) forms column
  //    32 g + lane of the stage rows s, s + ns, ...
  const int ng = (c + 31) >> 5;
  const int g = warp % ng;
  const int s = warp / ng;
  const int ns = pbt::kBlockedWarps / ng;
  const int J = 32 * g + lane;
  const int Jc = min(J, c - 1);
  const T dJ = dg[Jc];
  constexpr int kPer = kStageRows / 2;  // stage rows per warp, ns >= 2
  for (int h0 = r0; h0 < r1; h0 += kStageRows) {
    T v[kLoadRows];
#pragma unroll
    for (int t = 0; t < kLoadRows; ++t) {
      v[t] = B[min(h0 + i0 + 2 * t, r1 - 1) * c + jc];
    }
    if (j < c) {
#pragma unroll
      for (int t = 0; t < kLoadRows; ++t) {
        St[(i0 + 2 * t) * c + j] = v[t];
      }
    }
    __syncthreads();
    if (s < ns) {
      const T* rows[kPer];
      T acc[kPer];
#pragma unroll
      for (int t = 0; t < kPer; ++t) {
        rows[t] = St + min(s + t * ns, kStageRows - 1) * c;
        acc[t] = T(0);
      }
#pragma unroll 4
      for (int k = 0; k < c; ++k) {
        const T a = A[k * ld + Jc];
        const T lv = J < wl ? (k < J ? a : (k == J ? dJ : T(0))) : T(0);
#pragma unroll
        for (int t = 0; t < kPer; ++t) {
          acc[t] = fma(rows[t][k], lv, acc[t]);
        }
      }
#pragma unroll
      for (int t = 0; t < kPer; ++t) {
        const int r = s + t * ns;
        const int h = h0 + r;
        if (r < kStageRows && h < r1 && J < c) {
          T out;
          if (h < wl) {
            out = J < wl ? A[h * ld + J] : T(0);
          } else {
            out = J < wl ? acc[t] : T(0);
          }
          O[h * c + J] = out - St[r * c + J];
        }
      }
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
  if (c < 1 || c > 128 || H < c || nchunk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int chunk = (H + nchunk - 1) / nchunk;
  const int units = P * nchunk;  // < 2^31, checked by the wrapper
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c <= 32) {
    const size_t smem = kWarpsPerCta * kWarpElems<T> * sizeof(T);
    cudaError_t err = cudaFuncSetAttribute(
        finalize_warp_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
    const int grid = (units + kWarpsPerCta - 1) / kWarpsPerCta;
    finalize_warp_kernel<T><<<grid, kWarpsPerCta * 32, smem, s>>>(
        blk, w, diff, units, H, c, cnt, nchunk, chunk);
  } else {
    // K1's blocked routine, then the stage
    const size_t smem =
        (pbt::blocked_smem_elems(c) + kStageRows * c) * sizeof(T);
    cudaError_t err = cudaFuncSetAttribute(
        finalize_blocked_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
    const int grid = units;
    finalize_blocked_kernel<T><<<grid, pbt::kBlockedThreads, smem, s>>>(
        blk, w, diff, H, c, cnt, nchunk, chunk);
  }
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
