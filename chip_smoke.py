#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``parsy_bench_tpu_torch``) on one
NVIDIA GPU:

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 off for matmuls and cuDNN, float32 matmul precision
   "highest".  Exits 2 without a result when CUDA is not available;
2. build: compiles the CUDA kernels from ``parsy_bench_tpu_torch/csrc``
   (one nvcc per source, all at once) and loads them; reports whether the
   port's native inspector library (``parsy_bench_tpu_torch/native``, g++
   at first import) loaded (without it analyze falls back to numpy);
3. K1, the batched Cholesky + inverse kernel, against its plain PyTorch
   version on the card, f32, at the main path's batch shapes (P, c) =
   (27,520, 32), (87, 128), (2,215, 32), (2, 128) and (1, 128) (checked
   against the plan in phase 4), at P = 6 for c = 8, 16, 48, 64, 96 and
   112, and in f64 at (64, 32) and (8, 128): L within 1e-5*c, Linv within
   1e-5 (f64: 1e-10*c and 1e-10), padded (w = 0) lanes exactly identity,
   ||L L^T - D||/||D|| < 1e-5 and ||Linv L - I|| < 1e-4 per block, NaN
   from a negative pivot at c = 16, 32, 48 and 128.  Each shape is timed
   with CUDA events beside the plain version and the library pair
   ``cholesky_ex`` + ``solve_triangular``, with its bound (bytes over
   3.35 TB/s or FLOPs over 67 TFLOP/s) and its share of the bound;
4. main path: ``CholeskySolver`` on ``laplace_3d(48)`` (n = 110,592),
   nested dissection, f32, supernodal tier, on the card: analyze, one
   warm and five timed ``factorize`` calls, with K1's launch count equal
   to the plan's ``chol_inverse`` calls; one more factorize under
   ``torch.profiler`` gives the device operations, the device-busy ms and
   K1's launches and device ms by kernel name (a profile with no device
   time raises); gates: with b = L*1,
   ``solve_lower`` (the pair-granular fast solve) gives max|1 - x| < 1e-3,
   and ``solve(A*1)`` gives ||A x - b|| / ||b|| < 1e-3;
5. factor residual ||L L^T - A|| / ||A|| < 1e-3 at ``laplace_3d(24)``
   (n = 13,824; the host-side scipy product at n = 110,592 takes minutes);
6. K2, the fused finalize kernel, against its plain version on the card
   at the fused path's bucket shapes (27,456 x 32 x 32, 640 x 128 x 32,
   1 x 4,096 x 32, checked against the plan) and at 64 x 128 x 128, f32:
   diff within 1e-5*c of the largest |entry|, w = 0 lanes, lanes at or
   beyond cnt exactly zero, NaN from a negative pivot; the leaf once more
   at its widths and cnt in the plan (most of its lanes are one column
   wide), and f64 at 64 x 70 x 32 and 8 x 160 x 64 (bar 1e-10*c); both
   versions timed with CUDA events, with the bound of each shape; at the
   two tall shapes also the kernel's time at other row-chunk counts than
   the wrapper's (``ops/kernels.finalize_chunks``);
7. the fused configuration at n = 110,592: a second executor on the same
   plan with ``fused_finalize=True``; one warm call, then five fused and
   five default ``factorize`` calls in turns (ABBA), with K2 launched
   ``fused_calls_per_factorize`` and K1 ``chol_calls_per_factorize``
   times per fused call; the fused pools agree with the default pools
   within 1e-3 of the pool scale; gates as in phase 4 on the fused factor,
   and the factor residual < 1e-3 at ``laplace_3d(24)`` with
   ``fused_finalize=True``; the device operations and device time of one
   fused and one default factorize, and K2's launches and device ms in
   the fused one by kernel name, from ``torch.profiler``;
8. the forward solves: ``solve_prep`` timed once, the fast ``solve_lower``
   and the leveled ``_solve_lower_impl`` timed in turns, each with the
   b = L*1 gate, and the device operations of each counted with
   ``torch.profiler``;
9. the probes (``parsy_bench_tpu_torch.probes.run``): P1 copy bit-equal,
   P2 matmul within 1e-5*K*max|a|*max|b| and ones @ 2I exactly 2, P3
   gather within 1e-5 of the largest |sum|, at a 32 MB pool (warm L2) and
   a 256 MB pool (L2 flushed before each call), with GB/s; the yardsticks
   ``x.clone()`` (P1), ``torch.matmul`` (P2) and ``embedding_bag`` in
   mode "sum" (P3, checked against the plain gather) timed at the same
   shapes; P3 and ``embedding_bag`` once more on the 256 MB pool, L2
   flushed before each call, in 12 interleaved pairs (P3, bag, bag, P3,
   ...), with the medians and the spread of each.

Output: JSON lines of each phase's numbers, the card line, one JSON line
``{"kernels": [...]}`` (K1, K2, P1, P2, P3, each with the launches of its
path's run, its times, bound and yardstick) and, last,
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of the JAX
package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

#: main-path batch shapes (P, c) of the chol_inverse kernel at
#: laplace_3d(48), checked against the plan below: the largest per width
#: class first, then a middle and the smallest c = 128 batches and the
#: second c = 32 batch
K1_SHAPES = ((27520, 32), (87, 128), (2215, 32), (2, 128), (1, 128))
#: widths the kernel takes off the main path, checked at a small batch
K1_SMALL = ((6, 8), (6, 16), (6, 48), (6, 64), (6, 96), (6, 112))
#: the fused path's K2 bucket shapes (P, H, c) at laplace_3d(48): the
#: largest lane count, a middle bucket and the tallest bucket (checked
#: against the plan below), and one c = 128 shape, a class the executor
#: leaves to K1
K2_SHAPES = ((27456, 32, 32), (640, 128, 32), (1, 4096, 32), (64, 128, 128))
#: the kernels' names as torch.profiler shows them (csrc/chol_inverse.cu,
#: csrc/finalize_fused.cu)
K1_NAMES = ("chol_inverse_warp_kernel", "chol_inverse_blocked_kernel")
K2_NAMES = ("finalize_warp_kernel", "finalize_blocked_kernel")


#: the H100 SXM's published peaks (NVIDIA's data sheet): HBM bytes/s and
#: float32 FLOP/s on the CUDA cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12


def _bound(nbytes, flops):
    """(least ms the card could take, "bytes" or "operations"): the
    larger of the bytes over the memory rate and the FLOPs over the f32
    peak."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


#: bytes of the smallest unit the card's memory moves (an L2 sector)
SECTOR = 32


def _k1_work(P, c, itemsize):
    """(bytes, FLOPs) of K1 on a contiguous (P, c, c) batch: the 32-byte
    sectors that hold D's lower triangle, read once (the kernel reads
    nothing above the diagonal), and L and Linv written whole once; c^3/3
    for the Cholesky and c^3/3 for the inverse."""
    import numpy as np
    r = np.arange(P * c, dtype=np.int64)     # row i = r % c of block r // c
    start = r * c * itemsize
    end = start + (r % c + 1) * itemsize
    sectors = int(((end - 1) // SECTOR - start // SECTOR + 1).sum())
    return (sectors * SECTOR + 2 * P * c * c * itemsize,
            P * 2 * c ** 3 / 3)


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _sync_s(torch, fn):
    """Host seconds of one call, synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _check_k1(torch, dense, kernels, P, c, gen, dtype=None):
    """Kernel vs plain version on random masked-SPD blocks (P, c, c), f32
    (bars 1e-5*c on L, 1e-5 on Linv) or f64 (1e-10*c, 1e-10); times the
    kernel, the plain version and the library pair (``cholesky_ex`` then
    ``solve_triangular``: no one PyTorch call returns L and Linv)."""
    dev = "cuda"
    dtype = dtype or torch.float32
    tol = 1e-5 if dtype == torch.float32 else 1e-10
    A = torch.randn((P, c, c), generator=gen, device=dev, dtype=dtype)
    eye = torch.eye(c, device=dev, dtype=dtype)
    D0 = torch.bmm(A, A.transpose(1, 2)) + c * eye
    w = torch.randint(0, c + 1, (P,), generator=gen, device=dev,
                      dtype=torch.int32)
    w[::7] = 0
    w[1::7] = c
    D = dense.masked_spd(D0, w, c, dtype)
    L, Linv = kernels.cholesky_inverse_cuda(D)
    Lp, Linvp = dense.cholesky_inverse(D)
    torch.cuda.synchronize()
    err_l = float((L - Lp).abs().max())
    err_i = float((Linv - Linvp).abs().max())
    if not (err_l <= tol * c and err_i <= tol):
        raise AssertionError(f"K1 disagrees with its plain version at "
                             f"({P}, {c}, {dtype}): |dL| {err_l:.3e} (bar "
                             f"{tol * c:.1e}), |dLinv| {err_i:.3e} "
                             f"(bar {tol:.0e})")
    pad = w == 0
    if not (torch.equal(L[pad], eye.expand(int(pad.sum()), c, c))
            and torch.equal(Linv[pad], eye.expand(int(pad.sum()), c, c))):
        raise AssertionError(f"K1 padded lanes are not identity at c={c}")
    if not (torch.equal(torch.triu(L, 1), torch.zeros_like(L))
            and torch.equal(torch.triu(Linv, 1), torch.zeros_like(L))):
        raise AssertionError("K1 output not zero above the diagonal")
    res = (torch.linalg.matrix_norm(torch.bmm(L, L.transpose(1, 2)) - D)
           / torch.linalg.matrix_norm(D)).max().item()
    inv = torch.linalg.matrix_norm(torch.bmm(Linv, L) - eye).max().item()
    if not (res < 1e-5 and inv < 1e-4):
        raise AssertionError(f"K1 at ({P}, {c}): ||LL^T-D||/||D|| {res:.3e}"
                             f", ||Linv L - I|| {inv:.3e}")
    from parsy_bench_tpu_torch.probes import cuda_ms

    def library():
        Ll = torch.linalg.cholesky_ex(D).L
        return Ll, torch.linalg.solve_triangular(Ll, eye.expand(P, c, c),
                                                  upper=False)

    ms = cuda_ms(lambda: kernels.cholesky_inverse_cuda(D), 20)
    plain_ms = cuda_ms(lambda: dense.cholesky_inverse(D), 5)
    library_ms = cuda_ms(library, 5)
    nbytes, flops = _k1_work(P, c, D.element_size())
    bound_ms, bound_by = _bound(nbytes, flops)
    return dict(shape=[P, c, c], dtype=str(dtype).split(".")[-1],
                max_abs_err_L=err_l, max_abs_err_Linv=err_i,
                rel_residual=res, inverse_err=inv, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms,
                library="cholesky_ex + solve_triangular (two calls)",
                bound_ms=bound_ms, bound_by=bound_by,
                bound_share=bound_ms / ms, bytes=nbytes, flops=flops)


def _check_k2(torch, dense, kernels, P, H, c, gen, w=None, cnt=None,
              dtype=None):
    """K2 vs its plain version on a random bucket (P, H, c) with SPD tops,
    f32 (bar 1e-5*c of the largest |entry|) or f64 (1e-10*c): by default
    random widths with w = 0 and full-width lanes, and lanes at or beyond
    cnt; or the widths ``w`` and ``cnt`` given."""
    from parsy_bench_tpu_torch.probes import cuda_ms
    dev = "cuda"
    dtype = dtype or torch.float32
    tol = 1e-5 if dtype == torch.float32 else 1e-10
    blk = torch.randn((P, H, c), generator=gen, device=dev, dtype=dtype)
    A = torch.randn((P, c, c), generator=gen, device=dev, dtype=dtype)
    blk[:, :c, :] = (torch.bmm(A, A.transpose(1, 2))
                     + c * torch.eye(c, device=dev, dtype=dtype))
    if w is None:
        w = torch.randint(1, c + 1, (P,), generator=gen, device=dev,
                          dtype=torch.int32)
        w[1::7] = 0
        w[::7] = c
        cnt = P - P // 8
    diff = kernels.finalize_fused_cuda(blk, w, cnt)
    ref = dense.finalize_fused(blk, w, cnt)
    torch.cuda.synchronize()
    scale = max(1.0, float(ref.abs().max()))
    err = float((diff - ref).abs().max())
    if not err <= tol * c * scale:
        raise AssertionError(f"K2 disagrees with its plain version at ({P}, "
                             f"{H}, {c}, {dtype}): |d| {err:.3e} > "
                             f"{tol * c:.1e} * {scale:.3e}")
    if not torch.equal(diff[cnt:], torch.zeros_like(diff[cnt:])):
        raise AssertionError(f"K2 lanes at or beyond cnt are not zero at "
                             f"({P}, {H}, {c})")
    zero = (w == 0) & (torch.arange(P, device=dev) < cnt)
    if not torch.equal(diff[zero], -blk[zero]):
        raise AssertionError(f"K2 w = 0 lanes do not clear their block at "
                             f"({P}, {H}, {c})")
    ms = cuda_ms(lambda: kernels.finalize_fused_cuda(blk, w, cnt), 20)
    plain_ms = cuda_ms(lambda: dense.finalize_fused(blk, w, cnt), 5)
    # tall buckets: the time at other row-chunk counts (each chunk factors
    # its lane's top again), for the wrapper's choice
    nchunk = kernels.finalize_chunks(P, H, c)
    by_nchunk = {}
    if H > c and nchunk > 1:
        for n in sorted({1, max(1, nchunk // 4), nchunk,
                         min(2 * nchunk, -(-H // 8))}):
            got = kernels.finalize_fused_cuda(blk, w, cnt, n)
            if not float((got - ref).abs().max()) <= tol * c * scale:
                raise AssertionError(f"K2 at ({P}, {H}, {c}) in {n} chunks "
                                     f"disagrees with its plain version")
            by_nchunk[n] = cuda_ms(
                lambda: kernels.finalize_fused_cuda(blk, w, cnt, n), 20)
    # diff written once, w read, and blk read once on the lanes below cnt
    # (diff = out - blk needs all of it there, the top's upper triangle
    # too; the lanes at or beyond cnt are zeros and read nothing).  On
    # those lanes, at width wl = w clamped to [0, c]: the Cholesky and
    # inverse of the wl x wl top, 2 wl^3 / 3, and the panel product
    # Y = blk Linv^T on the rows below it, wl^2 per row
    item = blk.element_size()
    nbytes = P * H * c * item + P * 4 + cnt * H * c * item
    wl = w[:cnt].clamp(0, c).double()
    flops = float((2 * wl ** 3 / 3 + (H - wl) * wl ** 2).sum())
    bound_ms, bound_by = _bound(nbytes, flops)
    return dict(shape=[P, H, c], dtype=str(dtype).split(".")[-1], cnt=cnt,
                max_abs_err=err, scale=scale,
                ms=ms, plain_ms=plain_ms, library_ms=None, nchunk=nchunk,
                ms_by_nchunk=by_nchunk,
                bound_ms=bound_ms, bound_by=bound_by,
                bound_share=bound_ms / ms, bytes=nbytes, flops=flops)


def _device_ops(torch, fn, kernel=()):
    """(device operations, device ms) of one call, from torch.profiler;
    with ``kernel`` (names), also (launches, device ms) of the device
    operations whose name holds one of those strings.  Raises where the
    profile holds no device time, or none for ``kernel``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]

    def us(es):
        return sum(getattr(e, "device_time_total", None)
                   or getattr(e, "cuda_time_total", 0) for e in es)
    if not us(evs) > 0:
        raise AssertionError("torch.profiler recorded no device time")
    if not kernel:
        return len(evs), us(evs) / 1e3
    mine = [e for e in evs if any(k in e.name for k in kernel)]
    if not us(mine) > 0:
        raise AssertionError(f"torch.profiler recorded no device time for "
                             f"kernels named {kernel}")
    return len(evs), us(evs) / 1e3, len(mine), us(mine) / 1e3


def _interleaved(probes, a, b, flush, pairs=12, reps=5):
    """Medians and spread of two calls timed in turns (a, b, b, a, ...),
    ``pairs`` samples each, a sample the mean of ``reps`` calls with L2
    flushed before each (``probes.cuda_ms_cold``); and in how many of the
    pairs a was the faster."""
    ta, tb = [], []
    for k in range(pairs):
        order = ((a, ta), (b, tb)) if k % 2 == 0 else ((b, tb), (a, ta))
        for fn, acc in order:
            acc.append(probes.cuda_ms_cold(fn, reps, flush))

    def stats(t):
        s = sorted(t)
        return dict(median=s[len(s) // 2], min=s[0], max=s[-1], all=t)
    return dict(p3=stats(ta), library=stats(tb),
                p3_faster_in=sum(x < y for x, y in zip(ta, tb)),
                pairs=pairs, calls_per_sample=reps)


def main() -> int:
    # the port must not reach jax; make any such import fail loudly
    sys.modules["jax"] = None
    import torch

    # ---- 1. device -----------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = _card()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("float32 matmul precision is not 'highest'")

    import numpy as np

    import parsy_bench_tpu_torch.native as native
    from parsy_bench_tpu_torch import CholeskySolver, SolverConfig
    from parsy_bench_tpu_torch.core import generate
    from parsy_bench_tpu_torch.ops import build, dense, kernels

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    so = build.build()
    kernels._load()
    build_s = time.perf_counter() - t0
    print(f"build: {so} in {build_s:.2f} s")
    print(build.build_log(so).strip())
    print("native inspector library: "
          + ("loaded" if native.lib is not None else
             "NOT loaded (numpy fallback: analyze is slow)"))

    # ---- 3. K1 against its plain version ------------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    k1 = [_check_k1(torch, dense, kernels, P, c, gen)
          for P, c in K1_SHAPES]
    k1_small = [_check_k1(torch, dense, kernels, P, c, gen)
                for P, c in K1_SMALL]
    k1_f64 = [_check_k1(torch, dense, kernels, P, c, gen, torch.float64)
              for P, c in ((64, 32), (8, 128))]
    for r in k1 + k1_small + k1_f64:
        print("K1", json.dumps(r))
    for c in (16, 32, 48, 128):
        D = torch.eye(c, device="cuda").repeat(2, 1, 1) * 4.0
        D[1, 3, 3] = -1.0
        L, Linv = kernels.cholesky_inverse_cuda(D)
        if not (torch.isfinite(L[0]).all() and torch.isfinite(Linv[0]).all()
                and torch.isnan(L[1]).any() and torch.isnan(Linv[1]).any()):
            raise AssertionError(f"K1 does not give NaN on a negative "
                                 f"pivot at c = {c}")
    if kernels.cholesky_inverse_cuda(D[:0])[0].shape != (0, c, c):
        raise AssertionError("K1 mishandles an empty batch")

    # ---- 4. main path at n = 110,592 ----------------------------------
    a = generate.laplace_3d(48)
    cfg = SolverConfig(ordering="nd", dtype="float32", tier="supernodal")
    t0 = time.perf_counter()
    solver = CholeskySolver(a, cfg)
    analyze_s = time.perf_counter() - t0
    ex = solver.executor
    plan = solver.plan
    expected = ex.chol_calls_per_factorize
    shapes = ex.chol_batch_shapes()
    largest = tuple(sorted((max(P for P, c in shapes if c == cls), cls)
                           for cls in {c for _, c in shapes}))
    smallest128 = min(P for P, c in shapes if c == 128)
    if (tuple(sorted(K1_SHAPES[:2])) != largest
            or not set(K1_SHAPES) <= shapes or smallest128 != 1):
        raise AssertionError(f"plan's chol batches {sorted(shapes)} do not "
                             f"hold the shapes phase 3 checked {K1_SHAPES} "
                             f"(the largest per class first)")
    stats = dict(
        segments=len(plan.segments),
        level_steps=sum(s.nsteps for s in plan.segments),
        update_bucket_steps=sum(s.nsteps * len(s.upd)
                                for s in plan.segments),
        finalize_bucket_steps=sum(s.nsteps * len(s.fin)
                                  for s in plan.segments),
        update_delta=cfg.update_delta,
        chol_calls_per_factorize=expected,
        table_mb=ex.table_bytes / 1e6,
        pool_mb=plan.pool_elems() * 4 / 1e6)
    print("plan", json.dumps(stats), "timings", json.dumps(solver.timings))

    torch.cuda.reset_peak_memory_stats()
    kernels.cholesky_inverse_cuda.launches = 0
    warm_s, _ = _sync_s(torch, solver.factorize)
    if kernels.cholesky_inverse_cuda.launches != expected:
        raise AssertionError(
            f"K1 launched {kernels.cholesky_inverse_cuda.launches} times "
            f"in one factorize; the plan implies {expected}")
    times = [_sync_s(torch, solver.factorize)[0] for _ in range(5)]
    launches = kernels.cholesky_inverse_cuda.launches
    if launches != 6 * expected:
        raise AssertionError(f"K1 launched {launches} times in 6 "
                             f"factorizations; expected {6 * expected}")
    if not solver.factor_ok():
        raise AssertionError("factor has non-finite entries")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    times.sort()
    med = times[len(times) // 2]
    # K1's share of one default factorize's device time, by kernel name
    ops, busy_ms, k1_prof_n, k1_dev_ms = _device_ops(
        torch, lambda: ex.factorize(solver.ap.data), K1_NAMES)
    if k1_prof_n != expected:
        raise AssertionError(f"torch.profiler saw {k1_prof_n} K1 launches "
                             f"in one factorize; the plan implies "
                             f"{expected}")

    lmat = solver.factor_csc().to_scipy()
    b_l = np.asarray(lmat @ np.ones(a.n), dtype=np.float32)
    x = ex.solve_lower(solver.lx, b_l)
    lower_s = min(_sync_s(torch, lambda: ex.solve_lower(solver.lx, b_l))[0]
                  for _ in range(3))
    solve_err = float(np.max(np.abs(x.cpu().numpy() - 1.0)))
    if not solve_err < 1e-3:
        raise AssertionError(f"solve_lower with b = L*1: max|1 - x| "
                             f"{solve_err:.3e} >= 1e-3")
    b = a.spd_rhs_for_ones()
    bp = b[solver.perm].astype(np.float32)
    spd_s = min(_sync_s(torch, lambda: ex.solve_spd(solver.lx, bp))[0]
                for _ in range(3))
    xs = solver.solve(b)
    solve_res = solver.solve_residual(b, xs)
    if not solve_res < 1e-3:
        raise AssertionError(f"solve(A*1): ||Ax - b||/||b|| "
                             f"{solve_res:.3e} >= 1e-3")
    main = dict(
        n=int(a.n), nnz_l=int(solver.cc.sum()), gflop=plan.flops / 1e9,
        analyze_s=analyze_s, build_s=build_s, warm_factorize_s=warm_s,
        factorize_s_min_med_max=[times[0], med, times[-1]],
        gflops=plan.flops / med / 1e9, solve_spd_s=spd_s,
        solve_lower_s=lower_s, solve_lower_max_err=solve_err,
        solve_rel_residual=solve_res, peak_device_gb=peak_gb,
        k1_ms={f"{r['shape'][0]}x{r['shape'][1]}": r["ms"] for r in k1},
        k1_plain_ms={f"{r['shape'][0]}x{r['shape'][1]}": r["plain_ms"]
                     for r in k1},
        device_ops_per_factorize=ops, device_busy_ms=busy_ms,
        k1_device_ms=k1_dev_ms, k1_launches_per_factorize=k1_prof_n,
        card=card)
    print(json.dumps(main))

    # ---- 5. factor residual at n = 13,824 ------------------------------
    small = CholeskySolver(generate.laplace_3d(24), cfg,
                           device="cuda").factorize()
    residual = small.factor_residual()
    print(f"factor residual at n=13824: {residual:.3e}")
    if not residual < 1e-3:
        raise AssertionError(f"factor residual {residual:.3e} >= 1e-3")

    # ---- 6. K2 against its plain version ------------------------------
    from parsy_bench_tpu_torch.ops.supernodal import SupernodalExecutor
    exf = SupernodalExecutor(plan, "float32", "cuda", fused_finalize=True)
    fshapes = {(seg.fin[k].P, seg.fin[k].H, seg.fin[k].c)
               for seg, tabs in zip(plan.segments, exf._segs)
               for ks in tabs.fin_fused for k in ks}
    want = (max(fshapes), max(fshapes, key=lambda x: (x[1], x[0])))
    if (want != (K2_SHAPES[0], K2_SHAPES[2])
            or K2_SHAPES[1] not in fshapes):
        raise AssertionError(f"plan's fused buckets (largest P, tallest) "
                             f"{want} are not the shapes phase 6 checks "
                             f"{K2_SHAPES[:3]}")
    k2 = [_check_k2(torch, dense, kernels, P, H, c, gen)
          for P, H, c in K2_SHAPES]
    # the leaf once more at its widths and cnt in the plan (most lanes
    # there are one column wide)
    leaf = next(seg.fin[k] for seg, tabs in zip(plan.segments, exf._segs)
                for ks in tabs.fin_fused for k in ks
                if (seg.fin[k].P, seg.fin[k].H, seg.fin[k].c) == K2_SHAPES[0])
    k2_leaf = _check_k2(torch, dense, kernels, *K2_SHAPES[0], gen,
                        torch.as_tensor(np.asarray(leaf.w)[0], device="cuda",
                                        dtype=torch.int32),
                        int(np.asarray(leaf.cnt).ravel()[0]))
    k2_leaf["widths"] = "the plan's"
    vals, counts = np.unique(np.asarray(leaf.w)[0], return_counts=True)
    k2_leaf["width_counts"] = dict(zip(map(str, vals.tolist()),
                                       counts.tolist()))
    k2_f64 = [_check_k2(torch, dense, kernels, P, H, c, gen,
                        dtype=torch.float64)
              for P, H, c in ((64, 70, 32), (8, 160, 64))]
    for r in k2 + [k2_leaf] + k2_f64:
        print("K2", json.dumps(r))
    blk = (torch.eye(32, device="cuda") * 4.0).repeat(2, 2, 1)
    blk[1, 3, 3] = -1.0
    diff = kernels.finalize_fused_cuda(
        blk, torch.full((2,), 32, dtype=torch.int32, device="cuda"), 2)
    if not (torch.isfinite(diff[0]).all() and torch.isnan(diff[1]).any()):
        raise AssertionError("K2 does not give NaN on a negative pivot")

    # ---- 7. the fused configuration at n = 110,592 ---------------------
    fexp = (exf.fused_calls_per_factorize, exf.chol_calls_per_factorize)
    print("fused plan", json.dumps(dict(
        k2_calls_per_factorize=fexp[0], k1_calls_per_factorize=fexp[1],
        k1_calls_per_factorize_default=expected,
        k2_shapes=sorted(fshapes))))
    data = solver.ap.data

    def fused_call():
        kernels.finalize_fused_cuda.launches = 0
        kernels.cholesky_inverse_cuda.launches = 0
        t, pools = _sync_s(torch, lambda: exf.factorize(data))
        got = (kernels.finalize_fused_cuda.launches,
               kernels.cholesky_inverse_cuda.launches)
        if got != fexp:
            raise AssertionError(f"fused factorize launched (K2, K1) {got};"
                                 f" the plan implies {fexp}")
        k2_launches[0] += got[0]
        return t, pools

    k2_launches = [0]
    fwarm_s, pf = fused_call()
    t_fused, t_default = [], []
    for r in range(10):              # ABBA: d f f d d f f d d f
        if r % 4 in (0, 3):
            t_default.append(_sync_s(torch, lambda: ex.factorize(data))[0])
        else:
            t, pf = fused_call()
            t_fused.append(t)
    t_fused.sort()
    t_default.sort()
    if not all(torch.isfinite(p).all() for p in pf):
        raise AssertionError("fused factor has non-finite entries")
    pscale = max(float(p.abs().max()) for p in solver.lx)
    pool_err = max(float((p - q).abs().max()) for p, q in zip(pf, solver.lx))
    if not pool_err <= 1e-3 * pscale:
        raise AssertionError(f"fused pools differ from the default by "
                             f"{pool_err:.3e} > 1e-3 * {pscale:.3e}")
    import scipy.sparse as sp
    lpat = solver.lpat
    lf = sp.csc_matrix((exf.factor_values(pf).cpu().numpy().astype(
        np.float64), lpat.indices, lpat.indptr), shape=(a.n, a.n))
    bf = np.asarray(lf @ np.ones(a.n), dtype=np.float32)
    ferr = float(np.max(np.abs(exf.solve_lower(pf, bf).cpu().numpy() - 1)))
    if not ferr < 1e-3:
        raise AssertionError(f"fused solve_lower with b = L*1: max|1 - x| "
                             f"{ferr:.3e} >= 1e-3")
    xf = np.empty(a.n)
    xf[solver.perm] = exf.solve_spd(pf, bp).cpu().numpy()
    fres = solver.solve_residual(b, xf)
    if not fres < 1e-3:
        raise AssertionError(f"fused solve(A*1): ||Ax - b||/||b|| "
                             f"{fres:.3e} >= 1e-3")
    fsmall = CholeskySolver(generate.laplace_3d(24), cfg, device="cuda",
                            fused_finalize=True).factorize()
    fresid = fsmall.factor_residual()
    if not fresid < 1e-3:
        raise AssertionError(f"fused factor residual {fresid:.3e} >= 1e-3")
    fops = _device_ops(torch, lambda: exf.factorize(data), K2_NAMES)
    if fops[2] != fexp[0]:
        raise AssertionError(f"torch.profiler saw {fops[2]} K2 launches in "
                             f"one fused factorize; the plan implies "
                             f"{fexp[0]}")
    dops = _device_ops(torch, lambda: ex.factorize(data))
    fused = dict(
        warm_factorize_s=fwarm_s,
        fused_factorize_s_min_med_max=[t_fused[0], t_fused[2], t_fused[-1]],
        default_factorize_s_min_med_max=[t_default[0], t_default[2],
                                         t_default[-1]],
        fused_gflops=plan.flops / t_fused[2] / 1e9,
        default_gflops=plan.flops / t_default[2] / 1e9,
        k2_launches_per_factorize=fexp[0], k1_launches_per_factorize=fexp[1],
        fused_device_ops=fops[0], fused_device_ms=fops[1],
        k2_profiled_launches=fops[2], k2_device_ms=fops[3],
        default_device_ops=dops[0], default_device_ms=dops[1],
        pool_max_abs_diff=pool_err, pool_scale=pscale,
        solve_lower_max_err=ferr, solve_rel_residual=fres,
        factor_residual_n13824=fresid, card=card)
    print("fused", json.dumps(fused))

    # ---- 8. the forward solves -----------------------------------------
    prep_s, _ = _sync_s(torch, lambda: ex._linv_pools(solver.lx))
    linv = ex.solve_prep(solver.lx)
    bl = ex._vec(b_l)

    def fast():
        return ex._solve_lower_fast_impl(solver.lx, bl, linv)

    def leveled():
        return ex._solve_lower_impl(solver.lx, bl)

    t_fast, t_lev = [], []
    for fn, acc in ((fast, t_fast), (leveled, t_lev), (leveled, t_lev),
                    (fast, t_fast)) * 2:
        t, x = _sync_s(torch, fn)
        err = float((x - 1.0).abs().max())
        if not err < 1e-3:
            raise AssertionError(f"{fn.__name__} solve_lower with b = L*1: "
                                 f"max|1 - x| {err:.3e} >= 1e-3")
        acc.append(t)
    fast_ops = _device_ops(torch, fast)
    lev_ops = _device_ops(torch, leveled)
    solves = dict(
        solve_prep_s=prep_s, fast_solve_lower_s_min=min(t_fast),
        leveled_solve_lower_s_min=min(t_lev),
        fast_solve_lower_s=t_fast, leveled_solve_lower_s=t_lev,
        fast_device_ops=fast_ops[0], fast_device_ms=fast_ops[1],
        leveled_device_ops=lev_ops[0], leveled_device_ms=lev_ops[1],
        card=card)
    print("solves", json.dumps(solves))

    # ---- 9. the probes -------------------------------------------------
    from parsy_bench_tpu_torch import probes
    pk = (kernels.probe_copy_cuda, kernels.probe_matmul_cuda,
          kernels.probe_gather_cuda)
    for f in pk:
        f.launches = 0
    precs = probes.run()
    plaunch = [f.launches for f in pk]
    for r in precs:
        print("probe", json.dumps(r))
    gathers = [r for r in precs if r["variant"] == "gather"]
    # the yardsticks of P1 and P2 (one PyTorch call each) at their shapes,
    # and each probe's bound from its inputs
    x = torch.arange(1024, dtype=torch.float32, device="cuda").reshape(8,
                                                                      128)
    pa, pb = (torch.randn((128, 128), generator=gen, device="cuda")
              for _ in range(2))
    p_lib = [probes.cuda_ms(lambda: x.clone(), 50),
             probes.cuda_ms(lambda: torch.matmul(pa, pb), 50)]
    # P3's yardstick, one call: embedding_bag sums each group of PER
    # packed rows, (G, 8c), the plain gather's (G, 8, c) as a view; on
    # each probe pool (the same seeds), as the probe timed it
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda")
    for r in gathers:
        rows = int(r["pool_mb"] * 2**20) // (probes.WIDTH * 4)
        pool8 = torch.randn((rows // 8, 8 * probes.WIDTH), device="cuda",
                            generator=torch.Generator(device="cuda")
                            .manual_seed(rows))
        gidx = torch.as_tensor(probes.gather_indices(rows, probes.NIDX),
                               device="cuda").long().view(-1, probes.PER)

        def bag():
            return torch.nn.functional.embedding_bag(gidx, pool8,
                                                     mode="sum")
        ref = probes.gather_plain(pool8, gidx.view(-1), probes.PER)
        bag_err = float((bag().view(ref.shape) - ref).abs().max())
        if not bag_err <= 1e-5 * float(ref.abs().max()):
            raise AssertionError(f"embedding_bag differs from the plain "
                                 f"gather by {bag_err:.3e}")
        r["library_ms"] = (probes.cuda_ms_cold(bag, 20, flush)
                           if r["l2"] == "cold" else probes.cuda_ms(bag, 20))
        r["library"] = "embedding_bag(mode='sum')"
        if r["l2"] == "cold":
            idx32 = gidx.view(-1).int()
            p3_vs_bag = _interleaved(
                probes, lambda: kernels.probe_gather_cuda(
                    pool8, idx32, probes.PER), bag, flush)
            print("P3 vs embedding_bag, 256 MB pool, L2 flushed",
                  json.dumps(p3_vs_bag))
    del flush, pool8
    p_lib.append(gathers[0]["library_ms"])
    width = probes.WIDTH
    uniq = len(np.unique(probes.gather_indices(probes.ROWS, probes.NIDX)))
    p_work = [(2 * x.numel() * 4, 0),
              (3 * 128 * 128 * 4, 2 * 128 ** 3),
              # the distinct packed rows gathered, the indices, the sums
              (uniq * 8 * width * 4 + probes.NIDX * 4
               + probes.NIDX // probes.PER * 8 * width * 4,
               probes.NIDX * 8 * width)]

    # ---- 10. result ----------------------------------------------------
    print(card)
    k2_path = [r for r in k2 if r["shape"][2] <= 64]

    def probe_entry(name, line, rec, launches, k, **extra):
        bound_ms, bound_by = _bound(*p_work[k])
        return dict(name=name, route="cuda",
                    source="parsy_bench_tpu_torch/csrc/probes.cu",
                    replaces=line, launches=launches,
                    max_abs_err=max(r["max_abs_err"] for r in rec),
                    ms=rec[0]["ms"], plain_ms=rec[0]["plain_ms"],
                    bound_ms=bound_ms, bound_by=bound_by,
                    library_ms=p_lib[k], runs=rec, **extra)

    def summed(recs):
        """ms, plain_ms, library_ms and bound_ms of one call at each shape
        of ``recs``; bound_by of the shape with the largest bound."""
        lib = [r["library_ms"] for r in recs]
        return dict(ms=sum(r["ms"] for r in recs),
                    plain_ms=sum(r["plain_ms"] for r in recs),
                    bound_ms=sum(r["bound_ms"] for r in recs),
                    bound_by=max(recs, key=lambda r: r["bound_ms"])[
                        "bound_by"],
                    library_ms=None if None in lib else sum(lib))

    print(json.dumps({"kernels": [
        dict(name="cholesky_inverse", route="cuda",
             source="parsy_bench_tpu_torch/csrc/chol_inverse.cu",
             replaces="parsy_bench_tpu/ops/pallas_kernels.py:273",
             launches=launches,
             max_abs_err=max(max(r["max_abs_err_L"], r["max_abs_err_Linv"])
                             for r in k1),
             # one call at each main-path shape; the library time is the
             # pair cholesky_ex + solve_triangular
             **summed(k1), shapes=k1 + k1_small + k1_f64),
        dict(name="finalize_fused", route="cuda",
             source="parsy_bench_tpu_torch/csrc/finalize_fused.cu",
             replaces="parsy_bench_tpu/ops/pallas_kernels.py:235",
             launches=k2_launches[0],
             max_abs_err=max(r["max_abs_err"] for r in k2),
             # one call at each fused-path shape checked (c = 32)
             **summed(k2_path), shapes=k2 + [k2_leaf] + k2_f64),
        probe_entry("probe_copy", "scripts/pallas_probe.py:19",
                    [precs[0]], plaunch[0], 0),
        probe_entry("probe_matmul", "scripts/pallas_probe.py:34",
                    [precs[1]], plaunch[1], 1),
        probe_entry("probe_gather", "scripts/pallas_gather_probe.py:83",
                    gathers, plaunch[2], 2, hbm_pairs=p3_vs_bag),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
