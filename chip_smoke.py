#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``parsy_bench_tpu_torch``) on one
NVIDIA GPU:

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 off for matmuls and cuDNN, float32 matmul precision
   "highest".  Exits 2 without a result when CUDA is not available;
2. build: compiles the CUDA kernels from ``parsy_bench_tpu_torch/csrc``
   with nvcc and loads them; reports whether the shared inspector's
   native library loaded (without it analyze falls back to numpy);
3. the batched Cholesky + inverse kernel against its plain PyTorch
   version on the card, at the main path's batch shapes (27,520 x 32 x 32
   and 87 x 128 x 128, f32): L within 1e-5*c, Linv within 1e-5, padded
   (w = 0) lanes exactly identity, ||L L^T - D||/||D|| < 1e-5 and
   ||Linv L - I|| < 1e-4 per block, NaN from a negative pivot; both
   versions timed with CUDA events;
4. main path: ``CholeskySolver`` on ``laplace_3d(48)`` (n = 110,592),
   nested dissection, f32, supernodal tier, device "cuda": analyze, one
   warm and five timed ``factorize`` calls, with the kernel's launch count
   equal to the plan's ``chol_inverse`` calls; gates: with b = L*1,
   ``solve_lower`` gives max|1 - x| < 1e-3, and ``solve(A*1)`` gives
   ||A x - b|| / ||b|| < 1e-3;
5. factor residual ||L L^T - A|| / ||A|| < 1e-3 at ``laplace_3d(24)``
   (n = 13,824; the host-side scipy product at n = 110,592 takes minutes).

Output: one JSON line of main-path numbers, the card line, one JSON line
``{"kernels": [...]}`` and, last, ``{"ok": true, "device": {...}}``.
Imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

#: main-path batch shapes of the chol_inverse kernel at laplace_3d(48):
#: the largest (P, c) per width class (checked against the plan below)
K1_SHAPES = ((27520, 32), (87, 128))


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(torch, fn, reps, warm=2):
    """Mean milliseconds per call over ``reps`` calls, CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _sync_s(torch, fn):
    """Host seconds of one call, synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _check_k1(torch, dense, kernels, P, c, gen):
    """Kernel vs plain version on random masked-SPD blocks (P, c, c)."""
    dev = "cuda"
    A = torch.randn((P, c, c), generator=gen, device=dev)
    D0 = torch.bmm(A, A.transpose(1, 2)) + c * torch.eye(c, device=dev)
    w = torch.randint(0, c + 1, (P,), generator=gen, device=dev,
                      dtype=torch.int32)
    w[::7] = 0
    w[1::7] = c
    D = dense.masked_spd(D0, w, c, torch.float32)
    L, Linv = kernels.cholesky_inverse_cuda(D)
    Lp, Linvp = dense.cholesky_inverse(D)
    torch.cuda.synchronize()
    err_l = float((L - Lp).abs().max())
    err_i = float((Linv - Linvp).abs().max())
    if not (err_l <= 1e-5 * c and err_i <= 1e-5):
        raise AssertionError(f"K1 disagrees with its plain version at "
                             f"({P}, {c}): |dL| {err_l:.3e} (bar "
                             f"{1e-5 * c:.1e}), |dLinv| {err_i:.3e} "
                             f"(bar 1e-5)")
    eye = torch.eye(c, device=dev)
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
    ms = _cuda_ms(torch, lambda: kernels.cholesky_inverse_cuda(D), 20)
    plain_ms = _cuda_ms(torch, lambda: dense.cholesky_inverse(D), 5)
    return dict(shape=[P, c, c], max_abs_err_L=err_l,
                max_abs_err_Linv=err_i, rel_residual=res,
                inverse_err=inv, ms=ms, plain_ms=plain_ms)


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

    import parsy_bench_tpu.native as native
    from parsy_bench_tpu.core import generate
    from parsy_bench_tpu_torch import CholeskySolver, SolverConfig
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
    for r in k1:
        print("K1", json.dumps(r))
    D = torch.eye(16, device="cuda").repeat(2, 1, 1) * 4.0
    D[1, 3, 3] = -1.0
    L, Linv = kernels.cholesky_inverse_cuda(D)
    if not (torch.isfinite(L[0]).all() and torch.isnan(L[1]).any()
            and torch.isnan(Linv[1]).any()):
        raise AssertionError("K1 does not give NaN on a negative pivot")
    if kernels.cholesky_inverse_cuda(D[:0])[0].shape != (0, 16, 16):
        raise AssertionError("K1 mishandles an empty batch")

    # ---- 4. main path at n = 110,592 ----------------------------------
    a = generate.laplace_3d(48)
    cfg = SolverConfig(ordering="nd", dtype="float32", tier="supernodal")
    t0 = time.perf_counter()
    solver = CholeskySolver(a, cfg, device="cuda")
    analyze_s = time.perf_counter() - t0
    ex = solver.executor
    plan = solver.plan
    expected = ex.chol_calls_per_factorize
    shapes = ex.chol_batch_shapes()
    largest = tuple(sorted((max(P for P, c in shapes if c == cls), cls)
                           for cls in {c for _, c in shapes}))
    if tuple(sorted(K1_SHAPES)) != largest:
        raise AssertionError(f"plan's largest chol batches {largest} are "
                             f"not the shapes phase 3 checked {K1_SHAPES}")
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
        card=card)
    print(json.dumps(main))

    # ---- 5. factor residual at n = 13,824 ------------------------------
    small = CholeskySolver(generate.laplace_3d(24), cfg,
                           device="cuda").factorize()
    residual = small.factor_residual()
    print(f"factor residual at n=13824: {residual:.3e}")
    if not residual < 1e-3:
        raise AssertionError(f"factor residual {residual:.3e} >= 1e-3")

    # ---- 6. result -----------------------------------------------------
    print(card)
    print(json.dumps({"kernels": [dict(
        name="cholesky_inverse", route="cuda",
        source="parsy_bench_tpu_torch/csrc/chol_inverse.cu",
        replaces="parsy_bench_tpu/ops/pallas_kernels.py:273",
        launches=launches,
        max_abs_err=max(max(r["max_abs_err_L"], r["max_abs_err_Linv"])
                        for r in k1),
        # one call at each main-path shape
        ms=sum(r["ms"] for r in k1),
        plain_ms=sum(r["plain_ms"] for r in k1),
        shapes=k1)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
