"""Headline benchmark of the port: supernodal Cholesky factorization and
blocked triangular solve throughput on one card.

    python -m parsy_bench_tpu_torch.bench

The counterpart of the repository's ``bench.py``, with its protocol and
its JSON keys (``BENCH_KEYS``): ``laplace_3d(48)`` (n = 110,592), nested
dissection, f32, supernodal tier; analyze once, upload A's values once,
then 5 rounds of 5 ``factorize_segmented(group=16)`` calls (min, median
and max per call) and 3 rounds of ``solve_loop(lx, b, 5)`` with b = L*1,
gated at the reference's bars (factor residual and max|1 - x| < 1e-3).
Times are host seconds around calls that end in
``torch.cuda.synchronize()``; the first factorize captures the programs
(``compile_s``).  The baselines are ``bench.py``'s, independent of the
hardware: the reference's calibrated 4-thread cost model over the plan's
flops (``vs_baseline``), scipy's compiled triangular solve measured on the
same factor (``trisolve_vs_baseline``) and the reference's TRSV/GEMV model
over the plan's partition (``trisolve_vs_ref_model``).

The builds stay out of every timer: the native inspector library is built
by g++ when the package is imported, before ``run`` starts, and the CUDA
kernels are built and loaded before the analyze (``kernel_build_s``).
There is no fallback: without CUDA the default device raises, and a
failed capture or launch raises.  ``EXTRA_KEYS`` are the keys the line
adds to ``bench.py``'s.  Prints one JSON line.
"""
from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

from parsy_bench_tpu_torch import native
from parsy_bench_tpu_torch.config import SolverConfig
from parsy_bench_tpu_torch.core import generate
from parsy_bench_tpu_torch.models import CholeskySolver
from parsy_bench_tpu_torch.ops.device import resolve_device

# reference cost model: t_gemm = 2.429e-10 * ijk s for 2ijk flops
_REF_SEC_PER_FLOP = 2.429e-10 / 2.0
_REF_THREADS = 4  # scripts/eval.sh protocol
_ITERS = 5
_GRID = 48        # laplace_3d(48): n = 110,592
_GROUP = 16

#: ``bench.py``'s keys, in its order
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "n",
              "factor_residual", "factorize_s_min_med_max",
              "trisolve_gnnz_per_s", "trisolve_vs_baseline",
              "trisolve_vs_ref_model", "trisolve_residual", "analyze_s",
              "compile_s", "group")
#: the keys the port's line adds: the card's name and power limit
#: (``"cpu"`` on the CPU), the torch and CUDA versions, the update mode,
#: whether the native inspector library loaded, the kernels' build and
#: load seconds (null on the CPU, where none is built) and the seconds of
#: the factor-residual check
EXTRA_KEYS = ("device", "torch", "cuda", "update_delta", "native_lib",
              "kernel_build_s", "residual_s")


def _ref_trisolve_model_s(plan) -> float:
    """Reference calibrated blocked-trisolve time for our partition:
    per supernode one dense TRSV on the w-wide diag block plus one GEMV
    on the (h-w, w) off-diag block (performanceModel.h:26-88 PERF_TRSV /
    PERF_GEMV), at the 4-thread eval protocol."""
    lay = plan.layout
    w = np.diff(lay.part.sptr).astype(np.float64)
    h = np.diff(lay.rptr).astype(np.float64)
    hw = np.maximum(h - w, 0.0)
    trsv = 3.224536e-10 * w * w + 1.709178e-08 * w + 1.947268e-07
    gemv = (6.192657e-10 * hw * w - 2.884799e-09 * hw
            + 7.594831e-10 * w + 3.575035e-07)
    return float(np.sum(trsv + np.maximum(gemv, 0.0))) / _REF_THREADS


def _scipy_trsv_s(lmat, b, iters: int = 3) -> float:
    """Measured scipy compiled triangular solve on the same factor."""
    import scipy.sparse.linalg as spla
    lcsr = lmat.tocsr()
    spla.spsolve_triangular(lcsr, b, lower=True)  # warm
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        spla.spsolve_triangular(lcsr, b, lower=True)
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def build_kernels(dev):
    """Seconds to build (nvcc, unless the sources' library exists) and
    load the CUDA kernels on the card; None on the CPU."""
    if dev.type != "cuda":
        return None
    from parsy_bench_tpu_torch.ops import build, kernels
    t0 = time.perf_counter()
    build.build()
    kernels._load()
    return time.perf_counter() - t0


def analyze(grid: int, dev):
    """(A, the analyzed solver, analyze seconds)."""
    a = generate.laplace_3d(grid)
    t0 = time.perf_counter()
    solver = CholeskySolver(a, SolverConfig(ordering="nd", dtype="float32",
                                            tier="supernodal"), device=dev)
    return a, solver, time.perf_counter() - t0


def factorize(solver, dev):
    """A's values uploaded once; the first ``factorize_segmented`` (it
    captures the programs), then ``_ITERS`` calls in each of 5 rounds.
    Sets ``solver.lx`` from the last call; returns (compile seconds,
    seconds per call of each round)."""
    ex = solver.executor
    data = torch.as_tensor(solver.ap.data.astype(np.float32), device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    ex.factorize_segmented(data, group=_GROUP)
    _sync(dev)
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _i in range(_ITERS):
            lx = ex.factorize_segmented(data, group=_GROUP)
        _sync(dev)
        times.append((time.perf_counter() - t0) / _ITERS)
    solver.lx = lx
    return compile_s, times


def rhs(solver):
    """(L as a scipy matrix, b = L*1 in f32): the reference's
    constructed-solution right-hand side (common/Util.h:277)."""
    lmat = solver.factor_csc().to_scipy()
    return lmat, np.asarray(lmat @ np.ones(solver.a.n), dtype=np.float32)


def solve(solver, b, dev):
    """One warm ``solve_loop(lx, b, _ITERS)``, then 3 timed rounds;
    returns (the warm call's x on the host, seconds per solve of each
    round)."""
    ex = solver.executor
    x_warm = ex.solve_loop(solver.lx, b, _ITERS)
    _sync(dev)
    stimes = []
    for _ in range(3):
        t0 = time.perf_counter()
        ex.solve_loop(solver.lx, b, _ITERS)
        _sync(dev)
        stimes.append((time.perf_counter() - t0) / _ITERS)
    return x_warm.cpu().numpy(), stimes


def run(grid: int = _GRID, device="cuda") -> dict:
    """The benchmark at ``laplace_3d(grid)`` on ``device``: the line's
    keys (``BENCH_KEYS`` and ``EXTRA_KEYS``) and values.  Raises
    ``SystemExit`` with ``bench.py``'s message when a gate fails."""
    dev = resolve_device(device)
    if dev.type == "cuda" and native.lib is None:
        raise RuntimeError("the native inspector library did not load: "
                           "analyze_s would time the numpy inspector")
    kernel_build_s = build_kernels(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("float32 matmul precision is not 'highest'")

    a, solver, analyze_s = analyze(grid, dev)
    compile_s, times = factorize(solver, dev)
    median = sorted(times)[len(times) // 2]
    lmat, b = rhs(solver)
    x_warm, stimes = solve(solver, b, dev)
    smedian = sorted(stimes)[len(stimes) // 2]
    nnzl = int(solver.cc.sum())   # nnz(L) without materializing the pattern
    scipy_trsv = _scipy_trsv_s(lmat, b)
    ref_model_trsv = _ref_trisolve_model_s(solver.plan)

    # correctness gates, the reference's bars: the factor's Frobenius
    # residual (choleskyTest01.cpp:538-546) and, with b = L*1, every
    # |1 - x_i| (testTriangular, common/Util.h:294-306)
    t0 = time.perf_counter()
    residual = solver.factor_residual()
    residual_s = time.perf_counter() - t0
    if not (residual < 1e-3):
        raise SystemExit(f"factor residual {residual:.3e} exceeds 1e-3 "
                         f"— benchmark invalid")
    solve_err = float(np.max(np.abs(x_warm - 1.0)))
    if not (solve_err < 1e-3):
        raise SystemExit(f"trisolve error {solve_err:.3e} exceeds 1e-3 "
                         f"— benchmark invalid")

    flops = solver.plan.flops
    gflops = flops / median / 1e9
    ref_time = flops * _REF_SEC_PER_FLOP / _REF_THREADS
    return {
        "metric": "supernodal_cholesky_factorize_gflops",
        "value": round(gflops, 4),
        "unit": "GFLOP/s",
        "vs_baseline": round(ref_time / median, 4),
        "n": int(a.n),
        "factor_residual": float(f"{residual:.3e}"),
        "factorize_s_min_med_max": [round(min(times), 4), round(median, 4),
                                    round(max(times), 4)],
        "trisolve_gnnz_per_s": round(nnzl / smedian / 1e9, 4),
        "trisolve_vs_baseline": round(scipy_trsv / smedian, 4),
        "trisolve_vs_ref_model": round(ref_model_trsv / smedian, 4),
        "trisolve_residual": float(f"{solve_err:.3e}"),
        "analyze_s": round(analyze_s, 1),
        "compile_s": round(compile_s, 1),
        "group": _GROUP,
        "device": _card() if dev.type == "cuda" else "cpu",
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "update_delta": solver.config.update_delta,
        "native_lib": native.lib is not None,
        "kernel_build_s": kernel_build_s,
        "residual_s": residual_s,
    }


def main() -> None:
    print(json.dumps(run()))


if __name__ == "__main__":
    main()
