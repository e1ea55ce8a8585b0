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
// P2, matmul: C[l] = A[l] op(B[l]) for l < L, f32 in, f32 out.  A is
// (L, M, K) and C (L, M, N), both row-major; B is (L, K, N) or, with
// trans_b, (L, N, K) (op(B) = B^T), so that one entry point serves the
// TPU probe's 128 x 128 product and the update products of
// ops/supernodal.update_block, A B_raw^T and the one-hot Chat S^T.  All
// products are f32-accurate 3xTF32 on the tensor cores: each operand is
// split into hi = tf32(x) (cvt.rna) and lo = tf32(x - hi), and lo*hi +
// hi*lo + hi*hi is summed in f32 (a product loses about 2^-21
// relatively); never a single TF32 pass.
//
// What bounds it (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 10,
// PERF.md section 6): at the probe's 128^3, latency alone (the work's
// bound is 6.3e-5 ms, a launch about 0.002 ms).  At the 2,276 products
// of one main-path factorize, 164 GFLOP and 11.1 GB of operands and
// results (3.3 ms at the 3xTF32 ceiling, a third of 495 TF32 TFLOP/s,
// or at 3.35 TB/s): most products are small lanes (16 to 64 rows) in
// large batches, bound by memory and launch; one class, 256 x 136 x 128
// and 256 x 128 x 136 lanes, holds most of the operations.  Staging the
// operands, not the products, bounds the small tiles: on the same
// staging an FFMA register tile takes within a few percent of 3xTF32 on
// mma.sync there (tools/p2_ab.py), and only the 64-row wgmma tiles are
// faster than either at the large class.  Two kernels, one route each:
//   * matmul_kernel, small tiles: a warp computes a strip of 16 rows of
//     one lane against NI n-tiles of 8 columns with
//     mma.sync.m16n8k8.row.col.f32.tf32 (fragments split in registers,
//     the three products interleaved over up to kGroup tiles).  A block
//     of up to four warps stages its strips and B tiles for the whole
//     depth at once, one bulk copy (TMA, cp.async.bulk) a 16-byte
//     aligned row on one mbarrier (4-byte cp.async for rows that are
//     not), so a block makes one global round trip; it walks K in
//     rounds only where its stage outgrows kMmSmemCap.  Small lanes are
//     packed (four 16-row lanes a block, their B tiles side by side)
//     while the grid keeps kMmMinBlocks blocks; while it holds fewer
//     than kMmTargetWarps warps a strip's columns are split over warps
//     and then over blocks.
//   * matmul_wg_kernel, 64-row tiles (M >= 64, N >= 96, 64 <= K <= 136,
//     B's rows K-major and every row 16-byte aligned): one warpgroup
//     issues wgmma.mma_async m64nNk8 (N = 64 or 72, two column chunks
//     at the main path's 128 and 136) with A's fragments in registers
//     and B's hi and lo parts in shared memory in the no-swizzle
//     core-matrix layout, staged once a block (conflict-free stores);
//     A's rows land by bulk copies that overlap the previous tile's
//     products; all k-steps' 3 x (K / 8) wgmma are issued back to back
//     and one wait ends a tile.  Two blocks an SM.
// Ragged edges (M, N, K not multiples of 16 or 64, 8 and 8; K = 136; 37
// x 21 @ 21 x 45) are zero-filled in shared memory, never read out of
// bounds.  Padded rows (row strides of 4 or 8 floats mod 32) keep every
// fragment load free of bank conflicts.  Both kernels are launched with
// programmatic stream serialization, as P1 is: griddepcontrol.wait holds
// the first load until the kernel before has finished.

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
#include <cstring>

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

// ---------------------------------------------------------------- P2
constexpr int kMmWarps = 4;                 // warps of a block, at most
constexpr int kStrip = 16;                  // rows of a warp's strip
// n-tiles of 8 columns a warp holds at most: a strip of N = 136 (the
// update products' widest) in one warp
constexpr int kMmMaxNi = 17;
// warps the grid should hold before a strip's columns are split further:
// 16 on each of the H100's 132 SMs
constexpr long long kMmTargetWarps = 132 * 16;
// blocks the grid should hold before a block takes more than one strip:
// two on each SM
constexpr long long kMmMinBlocks = 2 * 132;
// dynamic shared memory one block may take (two blocks an SM)
constexpr int kMmSmemCap = 112 * 1024;
// n-tiles whose fragments a warp holds at once
constexpr int kGroup = 8;

// P2's launch shape, chosen on the host (mm_plan)
struct MmShape {
  int L, M, N, K;
  int spl;   // strip slots per lane: ceil(M / 16), padded to a power of
             // two below sb, else to a multiple of sb
  int sb;    // strips per block
  int wn;    // warps per strip
  int ncw;   // columns of a lane per block (a multiple of 8)
  int nnc;   // column chunks per lane
  int kc;    // depth staged per round (a multiple of 8)
  int vec;   // every row 16-byte aligned: 16-byte copies
  int sa;    // row stride of the A stage (floats)
  int sbs;   // row stride of the B stage (floats)
};

__device__ __forceinline__ float as_float(unsigned u) {
#if defined(__CUDA_ARCH__)
  return __uint_as_float(u);
#else
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
#endif
}

// x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero
__device__ __forceinline__ unsigned tf32_rna(float x) {
  unsigned r = 0;
#if defined(__CUDA_ARCH__)
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
#elif defined(PBT_CUDA_EMU)
  r = emu_cvt_rna_tf32(x);
#endif
  return r;
}

// x = hi + lo + O(2^-22 |x|): hi = tf32(x), lo = tf32(x - hi), where x -
// hi is exact in f32
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - as_float(hi));
}

// d += a b on the tensor cores, one warp: a 16 x 8 (row), b 8 x 8 (col),
// d 16 x 8 f32, in the fragments of the PTX ISA's mma.m16n8k8 (.tf32):
// with g = lane / 4 and t = lane % 4, a = {(g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4)}, b = {(t, g), (t + 4, g)} and d = {(g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1)}
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
#if defined(__CUDA_ARCH__)
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#elif defined(PBT_CUDA_EMU)
  emu_mma_m16n8k8_tf32(d, a, b);
#endif
}

// a 4-byte asynchronous copy global -> shared (cp.async), completed by
// cp_async_wait_all; elsewhere a plain copy
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(s), "l"(src) : "memory");
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void cp_async_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;" ::: "memory");
#endif
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
#if defined(__CUDA_ARCH__)
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
#elif defined(PBT_CUDA_EMU)
  return emu_smem_addr(p);
#else
  return 0;
#endif
}

__device__ __forceinline__ int cdiv_d(int x, int y) {
  return (x + y - 1) / y;
}

// the block's mbarrier for its bulk copies: one arrival (thread 0's, with
// the bytes to expect), completed when those bytes have landed
__device__ __forceinline__ void bar_init(unsigned long long* bar) {
#if defined(__CUDA_ARCH__)
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
#endif
}

__device__ __forceinline__ void bar_expect(unsigned long long* bar,
                                           unsigned bytes) {
#if defined(__CUDA_ARCH__)
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
#endif
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         unsigned parity) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
#endif
}

// one bulk copy (TMA) of `bytes` global -> shared, both ends 16-byte
// aligned and bytes a multiple of 16, completing on bar; elsewhere a copy
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
#else
  std::memcpy(dst, src, bytes);
#endif
}

// let the grid launched after this one start its preamble (it waits in
// griddepcontrol.wait until this grid has finished)
__device__ __forceinline__ void launch_dependents() {
#if defined(__CUDA_ARCH__)
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
#endif
}

// stage one row of `width` floats (a multiple of 4) in shared memory from
// global memory: its first `valid` floats copied (with vec, by one bulk
// copy completing on bar: both ends 16-byte aligned and valid a multiple
// of 4; else 4 bytes at a time by cp.async), the rest zero
__device__ __forceinline__ void stage_row(float* d, const float* src,
                                          int valid, int width, bool vec,
                                          unsigned long long* bar) {
  if (vec) {
    if (valid > 0) {
      bulk_copy(d, src, 4 * valid, bar);
    }
    for (int c = valid; c < width; c += 4) {
      *reinterpret_cast<float4*>(d + c) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  } else {
    for (int c = 0; c < width; ++c) {
      if (c < valid) {
        cp_async4(d + c, src + c);
      } else {
        d[c] = 0.0f;
      }
    }
  }
}

// Block b takes strip slots [sb * (b / nnc), + sb) and column chunk b %
// nnc; slot gs is rows [16 (gs % spl), + 16) of lane gs / spl.  Warp w
// computes slot w / wn against the NI n-tiles from (w % wn) NI 8 of the
// chunk.  Shared memory: sb A strips (16 x kc, row stride sa), then one B
// tile per lane of the block (ncw x kc with trans_b, TB; kc x ncw
// otherwise; row stride sbs).
template <int NI, bool TB>
__global__ void __launch_bounds__(32 * kMmWarps)
    matmul_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ c, MmShape s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem_raw);
  float* As = reinterpret_cast<float*>(smem_raw + 16);
  float* Bs = As + s.sb * kStrip * s.sa;
  const int lb = s.spl >= s.sb ? 1 : s.sb / s.spl;
  // the B stage spans the wn NI n-tiles of the warps (zeros past ncw)
  const int bw = s.wn * NI * 8;
  const int bslot = (TB ? bw : s.kc) * s.sbs;
  const int chunk = blockIdx.x % s.nnc;
  const int slot0 = blockIdx.x / s.nnc * s.sb;
  const int lane0 = slot0 / s.spl;
  const int n0 = chunk * s.ncw;
  const int ncols = min(s.ncw, s.N - n0);

  const int warp = threadIdx.x / 32;
  const int g = threadIdx.x % 32 / 4;
  const int t = threadIdx.x % 4;
  const int gs = slot0 + warp / s.wn;
  const int l = gs / s.spl;
  const int m0 = gs % s.spl * kStrip;
  const int wc0 = warp % s.wn * NI * 8;
  // the warp has columns of the chunk on a slot inside the batch and rows
  const bool live = l < s.L && m0 < s.M && wc0 < ncols;
  const float* Aw = As + warp / s.wn * kStrip * s.sa;
  const float* Bw = Bs + (l - lane0) * bslot;

  float acc[NI][4];
#pragma unroll
  for (int j = 0; j < NI; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  }
  if (threadIdx.x == 0) {
    bar_init(bar);
  }
  unsigned phase = 0;
  wait_prior_grids();
  for (int k0 = 0; k0 < s.K; k0 += s.kc) {
    const int kn = min(s.kc, s.K - k0);
    const int kp = (kn + 7) & ~7;
    // one row a thread at a time: the A strips' rows, then each lane's B
    // rows; zeros past the batch, the rows, the columns and K
    const int arows = s.sb * kStrip;
    const int brows = TB ? bw : kp;
    const int bcols = TB ? kp : bw;
    if (s.vec) {
      unsigned bytes = 0;
      for (int q = 0; q < s.sb; ++q) {
        const int sl = (slot0 + q) / s.spl;
        const int r0 = (slot0 + q) % s.spl * kStrip;
        bytes += sl < s.L ? max(0, min(kStrip, s.M - r0)) * kn * 4 : 0;
      }
      for (int j = 0; j < lb; ++j) {
        bytes += lane0 + j < s.L ? ncols * kn * 4 : 0;
      }
      if (threadIdx.x == 0) {
        bar_expect(bar, bytes);
      }
      __syncthreads();
    }
    for (int ri = threadIdx.x; ri < arows + lb * brows; ri += blockDim.x) {
      if (ri < arows) {
        const int q = ri / kStrip;
        const int r = ri % kStrip;
        const int sl = (slot0 + q) / s.spl;
        const int row = (slot0 + q) % s.spl * kStrip + r;
        stage_row(As + (q * kStrip + r) * s.sa,
                  a + (static_cast<size_t>(sl) * s.M + row) * s.K + k0,
                  sl < s.L && row < s.M ? kn : 0, kp, s.vec, bar);
      } else {
        const int j = (ri - arows) / brows;
        const int r = ri - arows - j * brows;
        const int sl = lane0 + j;
        const float* bl = b + static_cast<size_t>(sl) * s.N * s.K;
        if (TB) {
          stage_row(Bs + j * bslot + r * s.sbs,
                    bl + static_cast<size_t>(n0 + r) * s.K + k0,
                    sl < s.L && r < ncols ? kn : 0, bcols, s.vec, bar);
        } else {
          stage_row(Bs + j * bslot + r * s.sbs,
                    bl + static_cast<size_t>(k0 + r) * s.N + n0,
                    sl < s.L && r < kn ? ncols : 0, bcols, s.vec, bar);
        }
      }
    }
    if (s.vec) {
      bar_wait(bar, phase);
      phase ^= 1;
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    if (live) {
#pragma unroll 2
      for (int kk = 0; kk < kp; kk += 8) {
        const float* ap = Aw + g * s.sa + kk + t;
        unsigned ah[4], al[4];
        split_tf32(ap[0], ah[0], al[0]);
        split_tf32(ap[8 * s.sa], ah[1], al[1]);
        split_tf32(ap[4], ah[2], al[2]);
        split_tf32(ap[8 * s.sa + 4], ah[3], al[3]);
        // kGroup n-tiles at a time, their fragments loaded and split
        // first, then each of the three products across the group, so
        // that kGroup independent mma separate two on one accumulator
#pragma unroll
        for (int j0 = 0; j0 < NI; j0 += kGroup) {
          unsigned bh[kGroup][2], bl[kGroup][2];
#pragma unroll
          for (int u = 0; u < kGroup && j0 + u < NI; ++u) {
            const int n = wc0 + 8 * (j0 + u) + g;
            split_tf32(TB ? Bw[n * s.sbs + kk + t]
                          : Bw[(kk + t) * s.sbs + n], bh[u][0], bl[u][0]);
            split_tf32(TB ? Bw[n * s.sbs + kk + t + 4]
                          : Bw[(kk + t + 4) * s.sbs + n], bh[u][1], bl[u][1]);
          }
#pragma unroll
          for (int u = 0; u < kGroup && j0 + u < NI; ++u) {
            mma_tf32(acc[j0 + u], al, bh[u]);
          }
#pragma unroll
          for (int u = 0; u < kGroup && j0 + u < NI; ++u) {
            mma_tf32(acc[j0 + u], ah, bl[u]);
          }
#pragma unroll
          for (int u = 0; u < kGroup && j0 + u < NI; ++u) {
            mma_tf32(acc[j0 + u], ah, bh[u]);
          }
        }
      }
    }
    __syncthreads();
  }
  launch_dependents();
  if (!live) {
    return;
  }
  float* cl = c + static_cast<size_t>(l) * s.M * s.N + n0;
  const bool pair = s.N % 2 == 0;
#pragma unroll
  for (int j = 0; j < NI; ++j) {
    const int col = wc0 + 8 * j + 2 * t;     // in the chunk
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + g + 8 * h;
      if (row >= s.M || col >= ncols) {
        continue;
      }
      float* cp = cl + static_cast<size_t>(row) * s.N + col;
      if (pair && col + 1 < ncols) {
        *reinterpret_cast<float2*>(cp) =
            make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
      } else {
        cp[0] = acc[j][2 * h];
        if (col + 1 < ncols) {
          cp[1] = acc[j][2 * h + 1];
        }
      }
    }
  }
}

// d (64 x NW, f32, the warpgroup's registers) += a (64 x 8, tf32 in
// registers: warp w holds rows 16w..16w+15 as mma.m16n8k8's A fragment) b
// (8 x NW, tf32 in shared memory at the descriptor), one warpgroup
// (wgmma.mma_async m64nNk8; asynchronous until wgmma_wait); d holds rows
// 16w + g (+ 8) at columns 8j + 2t (+ 1) as d[4j .. 4j + 3], j < NW / 8
template <int NW>
__device__ __forceinline__ void wgmma_tf32(float (&d)[NW / 2],
                                           const unsigned (&a)[4],
                                           unsigned long long desc) {
#if defined(__CUDA_ARCH__)
  if constexpr (NW == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
          "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
          "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
          "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
  if constexpr (NW == 72) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 {"
          "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
          "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
          "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35"
        "}, {%36, %37, %38, %39}, %40, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
#elif defined(PBT_CUDA_EMU)
  emu_wgmma_m64nNk8_tf32<NW>(d, a, desc);
#endif
}

// order the warpgroup's register writes before its next wgmma
__device__ __forceinline__ void wgmma_fence() {
#if defined(__CUDA_ARCH__)
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#endif
}

// commit the wgmma issued so far and wait until they have completed
__device__ __forceinline__ void wgmma_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#endif
}

// keep the compiler from moving accesses of v across a wgmma
__device__ __forceinline__ void wgmma_reg_fence(float& v) {
#if defined(__CUDA_ARCH__)
  asm volatile("" : "+f"(v)::"memory");
#endif
}

// make this thread's shared-memory writes visible to the async proxy
// (the wgmma reading them)
__device__ __forceinline__ void fence_async_shared() {
#if defined(__CUDA_ARCH__)
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
#endif
}

// 64-row tiles.  A K-major operand in shared memory, no swizzle, as wgmma
// reads it: core matrices of 8 rows x 4 words (16 bytes a row, 128
// contiguous bytes), the core matrices of an 8-row group along K 128 bytes
// apart (the descriptor's leading byte offset), 8-row groups kc * 32 bytes
// apart (its stride byte offset).  Word offset of (n, k):
__device__ __forceinline__ int core_offset(int n, int k, int kc) {
  return ((n >> 3) * (kc >> 2) + (k >> 2)) * 32 + (n & 7) * 4 + (k & 3);
}

__device__ __forceinline__ unsigned long long wgmma_desc(const void* p,
                                                         int kc) {
  return (static_cast<unsigned long long>(smem_addr(p) >> 4) & 0x3FFF)
         | (static_cast<unsigned long long>(128 >> 4) << 16)
         | (static_cast<unsigned long long>((kc * 32) >> 4) & 0x3FFF) << 32;
}

// the deepest K the 64-row path takes (its A fragments live in registers)
constexpr int kWgMaxK = 136;

// C = A B^T for B (L, N, K), every row 16-byte aligned, K <= kWgMaxK, in
// 64-row tiles x NW-column chunks: block b takes chunk b % nch (nch =
// the chunks of N) and tiles [sb t, + sb) of lane l, with b / nch = l nbl
// + t (nbl: the lane's tile groups); one warpgroup a block.  B's chunk is
// staged once a block as tf32 hi and lo parts in the core-matrix layout:
// a warp loads 8 rows x 4 16-byte chunks at a time (full 32-byte sectors;
// 16 such loads in flight a thread), splits them, and its 8-thread store
// phases write 8 rows of one core matrix (no bank conflict); zeros past N
// and K.  A tile's rows land row-major in shared memory by bulk copies,
// which thread 0 issues for the next tile as soon as the current tile's
// fragments are in registers, so that they overlap its products; a tile's
// fragments, the whole depth, are split in registers and every k-step's
// three products (lo*hi, hi*lo, hi*hi) are issued as wgmma back to back,
// one wait ending the tile.  Shared memory: the mbarrier, B hi and B lo
// (NW x kc words each), A (64 x sa floats).
template <int NW>
__global__ void __launch_bounds__(128)
    matmul_wg_kernel(const float* __restrict__ a,
                     const float* __restrict__ b, float* __restrict__ c,
                     MmShape s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem_raw);
  unsigned* Bh = reinterpret_cast<unsigned*>(smem_raw + 16);
  unsigned* Bl = Bh + NW * s.kc;
  float* As = reinterpret_cast<float*>(Bl + NW * s.kc);
  constexpr int kSteps = kWgMaxK / 8;
  const int nch = s.nnc;
  const int tiles = cdiv_d(s.M, 64);
  const int nbl = cdiv_d(tiles, s.sb);
  const int ch = blockIdx.x % nch;
  const int l = blockIdx.x / nch / nbl;
  const int tile0 = blockIdx.x / nch % nbl * s.sb;
  const int tend = min(tile0 + s.sb, tiles);
  const int n0 = ch * NW;
  const int ncols = min(NW, s.N - n0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int kp = s.kc;                              // K rounded up to 8
  const int nks = kp / 8;
  const float* al = a + static_cast<size_t>(l) * s.M * s.K;
  if (threadIdx.x == 0) {
    bar_init(bar);
  }
  wait_prior_grids();

  // tile's A rows: thread 0 issues the bulk copies; rows past M and the
  // columns past K are zero (written by the block)
  auto stage_a = [&](int tile) {
    const int m0 = 64 * tile;
    const int rows = min(64, s.M - m0);
    if (threadIdx.x == 0) {
      bar_expect(bar, static_cast<unsigned>(rows * s.K * 4));
      for (int r = 0; r < rows; ++r) {
        bulk_copy(As + r * s.sa, al + static_cast<size_t>(m0 + r) * s.K,
                  4 * s.K, bar);
      }
    }
    if (threadIdx.x < 64) {
      float* d = As + threadIdx.x * s.sa;
      for (int q = threadIdx.x < rows ? s.K : 0; q < kp; q += 4) {
        *reinterpret_cast<float4*>(d + q) =
            make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
  };
  __syncthreads();
  stage_a(tile0);

  // B hi and lo: item j = (8-row group nb, 4-chunk group qb) is row 8 nb +
  // lane % 8, 16-byte chunk 4 qb + lane / 8 of that row
  const float* bl = b + (static_cast<size_t>(l) * s.N + n0) * s.K;
  const int kq = kp / 4;
  const int qbs = cdiv_d(kq, 4);
  const int items = NW / 8 * qbs;
  for (int j0 = warp; j0 < items; j0 += 16 * 4) {
    float4 v[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int j = j0 + 4 * u;
      const int n = j / qbs * 8 + lane % 8;
      const int k = 4 * (j % qbs * 4 + lane / 8);
      v[u] = j < items && n < ncols && k < s.K
                 ? *reinterpret_cast<const float4*>(
                       bl + static_cast<size_t>(n) * s.K + k)
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int j = j0 + 4 * u;
      const int n = j / qbs * 8 + lane % 8;
      const int k = 4 * (j % qbs * 4 + lane / 8);
      if (j < items && k < kp) {
        const int o = core_offset(n, k, kp);
        uint4 hi, lo;
        split_tf32(v[u].x, hi.x, lo.x);
        split_tf32(v[u].y, hi.y, lo.y);
        split_tf32(v[u].z, hi.z, lo.z);
        split_tf32(v[u].w, hi.w, lo.w);
        *reinterpret_cast<uint4*>(Bh + o) = hi;
        *reinterpret_cast<uint4*>(Bl + o) = lo;
      }
    }
  }
  fence_async_shared();

  float* cl = c + static_cast<size_t>(l) * s.M * s.N + n0;
  for (int tile = tile0; tile < tend; ++tile) {
    bar_wait(bar, (tile - tile0) & 1);
    __syncthreads();
    float acc[NW / 2];
#pragma unroll
    for (int e = 0; e < NW / 2; ++e) {
      acc[e] = 0.0f;
    }
    // A's fragments for every k-step: (r, k), (r + 8, k), (r, k + 4),
    // (r + 8, k + 4) with r = 16 warp + g and k = 8 ks + t
    const float* ap = As + (16 * warp + g) * s.sa + t;
    unsigned ah[kSteps][4], alo[kSteps][4];
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      if (ks < nks) {
        split_tf32(ap[8 * ks], ah[ks][0], alo[ks][0]);
        split_tf32(ap[8 * s.sa + 8 * ks], ah[ks][1], alo[ks][1]);
        split_tf32(ap[8 * ks + 4], ah[ks][2], alo[ks][2]);
        split_tf32(ap[8 * s.sa + 8 * ks + 4], ah[ks][3], alo[ks][3]);
      }
    }
    // the fragments are in registers: the next tile's rows may land
    __syncthreads();
    if (tile + 1 < tend) {
      stage_a(tile + 1);
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      if (ks < nks) {
        const unsigned long long dh = wgmma_desc(Bh + 64 * ks, kp);
        const unsigned long long dl = wgmma_desc(Bl + 64 * ks, kp);
        wgmma_tf32<NW>(acc, alo[ks], dh);
        wgmma_tf32<NW>(acc, ah[ks], dl);
        wgmma_tf32<NW>(acc, ah[ks], dh);
      }
    }
    wgmma_wait();
#pragma unroll
    for (int e = 0; e < NW / 2; ++e) {
      wgmma_reg_fence(acc[e]);
    }
    const bool pair = s.N % 2 == 0;
    const int r0 = 64 * tile + 16 * warp + g;
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int col = 8 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        if (row >= s.M || col >= ncols) {
          continue;
        }
        float* cp = cl + static_cast<size_t>(row) * s.N + col;
        if (pair && col + 1 < ncols) {
          *reinterpret_cast<float2*>(cp) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        } else {
          cp[0] = acc[4 * j + 2 * h];
          if (col + 1 < ncols) {
            cp[1] = acc[4 * j + 2 * h + 1];
          }
        }
      }
    }
  }
  launch_dependents();
}

int cdiv(long long x, long long y) {
  return static_cast<int>((x + y - 1) / y);
}

// the kernel's NI for a warp of ni n-tiles: the least instantiated
int ni_kernel(int ni) {
  return ni <= 1 ? 1 : ni <= 2 ? 2 : ni <= 4 ? 4 : ni <= 8 ? 8 : kMmMaxNi;
}

// shared-memory bytes of a launch shape, trans_b or not
size_t mm_smem(const MmShape& s, bool tb) {
  const int lb = s.spl >= s.sb ? 1 : s.sb / s.spl;
  const int bw = s.wn * ni_kernel(cdiv(s.ncw / 8, s.wn)) * 8;
  const int brows = tb ? bw : s.kc;
  return 16 + sizeof(float) * (static_cast<size_t>(s.sb) * kStrip * s.sa
                               + static_cast<size_t>(lb) * brows * s.sbs);
}

// the launch shape for L products (M, K) x op(B): the fewest warps per
// strip W (n-tiles per warp ceil(NT / W) <= kMmMaxNi) that give the grid
// kMmTargetWarps warps or leave a warp two n-tiles, raised further while a
// block's stage exceeds kMmSmemCap; then the depth is cut into rounds
// while it still does
MmShape mm_plan(int L, int M, int N, int K, bool tb, bool vec) {
  MmShape s{};
  s.L = L;
  s.M = M;
  s.N = N;
  s.K = K;
  s.vec = vec;
  const int nt = cdiv(N, 8);
  const int spl0 = cdiv(M, kStrip);
  const long long strips = static_cast<long long>(L) * spl0;
  int w = cdiv(nt, kMmMaxNi);
  while (w < nt && strips * w < kMmTargetWarps && cdiv(nt, w) > 1) {
    ++w;
  }
  s.kc = (K + 7) & ~7;
  // the shape for w warps per strip and at most sbmax strips a block
  auto shape = [&](int sbmax) {
    const int ni = cdiv(nt, w);
    s.nnc = cdiv(w, kMmWarps);
    const int tpc = cdiv(nt, s.nnc);            // n-tiles per chunk
    s.wn = cdiv(tpc, ni);
    s.ncw = 8 * tpc;
    s.sb = std::min(sbmax, s.wn == 1 ? kMmWarps : s.wn == 2 ? 2 : 1);
    if (spl0 >= s.sb) {
      s.spl = cdiv(spl0, s.sb) * s.sb;
    } else {
      s.spl = 1;
      while (s.spl < spl0) {
        s.spl *= 2;
      }
    }
    s.sa = s.kc + 4;
    const int bw = s.wn * ni_kernel(cdiv(tpc, s.wn)) * 8;
    s.sbs = tb ? s.kc + 4 : bw + ((8 - bw) % 32 + 32) % 32;
  };
  for (;;) {
    shape(kMmWarps);
    while (s.sb > 1 && static_cast<long long>(cdiv(
               static_cast<long long>(L) * s.spl, s.sb)) * s.nnc
                           < kMmMinBlocks) {
      shape(s.sb / 2);
    }
    if (mm_smem(s, tb) <= kMmSmemCap) {
      break;
    }
    if (w < nt) {
      ++w;
    } else if (s.kc > 8) {
      s.kc = ((s.kc / 2) + 7) & ~7;
    } else {
      break;
    }
  }
  return s;
}

template <int NI, bool TB>
cudaError_t mm_launch(const float* a, const float* b, float* c,
                      const MmShape& s, cudaStream_t stream) {
  void (*kernel)(const float*, const float*, float*, MmShape) =
      matmul_kernel<NI, TB>;
  const size_t smem = mm_smem(s, TB);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      return err;
    }
  }
  const long long slots = static_cast<long long>(s.L) * s.spl;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cdiv(slots, s.sb) * s.nnc);
  cfg.blockDim = dim3(32 * s.sb * s.wn);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a, b, c, s);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// shared-memory bytes of the 64-row path at depth K and chunk width NW
size_t wg_smem(int K, int nw) {
  const size_t kp = (K + 7) & ~7;
  return 16 + sizeof(float) * (2 * nw * kp + 64 * (kp + 4));
}

// the 64-row path for L products (M, K) x (N, K)^T in NW-column chunks: a
// block takes as many of a lane's 64-row tiles (sb, a power of two) as
// leave the grid two blocks on each of the 132 SMs
template <int NW>
cudaError_t wg_launch(const float* a, const float* b, float* c, int L,
                      int M, int N, int K, cudaStream_t stream) {
  void (*kernel)(const float*, const float*, float*, MmShape) =
      matmul_wg_kernel<NW>;
  MmShape s{};
  s.L = L;
  s.M = M;
  s.N = N;
  s.K = K;
  s.kc = (K + 7) & ~7;
  s.sa = s.kc + 4;
  s.nnc = cdiv(N, NW);
  const int tiles = cdiv(M, 64);
  const long long lanes = static_cast<long long>(L) * s.nnc;
  s.sb = 1;
  while (s.sb < tiles && lanes * cdiv(tiles, 2 * s.sb) >= kMmMinBlocks) {
    s.sb *= 2;
  }
  const size_t smem = wg_smem(K, NW);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(lanes * cdiv(tiles, s.sb));
  cfg.blockDim = dim3(128);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a, b, c, s);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool TB>
cudaError_t mm_dispatch(const float* a, const float* b, float* c,
                        const MmShape& s, cudaStream_t stream) {
  switch (ni_kernel(cdiv(s.ncw / 8, s.wn))) {
    case 1:
      return mm_launch<1, TB>(a, b, c, s, stream);
    case 2:
      return mm_launch<2, TB>(a, b, c, s, stream);
    case 4:
      return mm_launch<4, TB>(a, b, c, s, stream);
    case 8:
      return mm_launch<8, TB>(a, b, c, s, stream);
    default:
      return mm_launch<kMmMaxNi, TB>(a, b, c, s, stream);
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

// a (L, M, K), b (L, K, N) or with trans_b (L, N, K), c (L, M, N), all f32
// and contiguous; L M K, L N K and L M N < 2^31 (checked by the wrapper)
extern "C" int pbt_matmul_f32(const float* a, const float* b, float* c,
                              int L, int M, int N, int K, int trans_b,
                              void* stream) {
  if (L <= 0 || M <= 0 || N <= 0) {
    return 0;
  }
  if (K < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool aligned = ((reinterpret_cast<std::uintptr_t>(a)
                         | reinterpret_cast<std::uintptr_t>(b)) & 15) == 0;
  const bool vec = aligned && K % 4 == 0 && (trans_b || N % 4 == 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 64-row tiles on wgmma where one fills, B's rows are K-major and the
  // product is deep and wide enough to be bound by its operations
  if (trans_b && vec && M >= 64 && N >= 96 && K >= 64 && K <= kWgMaxK) {
    // the chunk width of fewer chunks, 64 at a tie
    return static_cast<int>(
        cdiv(N, 72) < cdiv(N, 64) ? wg_launch<72>(a, b, c, L, M, N, K, st)
                                  : wg_launch<64>(a, b, c, L, M, N, K, st));
  }
  const MmShape s = mm_plan(L, M, N, K, trans_b != 0, vec);
  return static_cast<int>(trans_b ? mm_dispatch<true>(a, b, c, s, st)
                                  : mm_dispatch<false>(a, b, c, s, st));
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
