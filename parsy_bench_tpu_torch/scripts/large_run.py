"""Reference-scale end-to-end run: the port's counterpart of
``scripts/large_run.py``.

    python -m parsy_bench_tpu_torch.scripts.large_run [out.json] [grid]
        [--device cuda]

``laplace_3d(grid)`` (64 by default, n = 262,144; 100 gives n = 1,000,000:
the reference's SuiteSparse set spans n = 36k-1.5M), nested dissection,
f32, supernodal tier, on the card unless ``--device cpu`` is given.  The
JAX script's protocol, step for step:

* analyze, with ``update_delta="gather"`` below ``REFERENCE_N`` and
  ``"scatter"`` at or above it (the gather tables cost about 1.2 GB at
  n = 1e6); prints the ``stage: analyze`` line;
* A's values uploaded once; the first ``factorize_segmented(group=8)``
  captures the programs and runs them (``compile_s``, the
  ``compile+first`` line), then 3 timed calls and their median;
* b = L*1 (``ones_rhs``): below ``REFERENCE_N`` from ``factor_csc()`` on
  the host; at or above it from masked row sums of the pools on the
  device (``pool_row_sums``), so neither L's pattern nor the int64 map of
  ``factor_values`` is built (nnz(L) = 614M at n = 1e6);
* ``solve_loop(lx, b, 3)`` warm, then 3 timed rounds;
* the gates (``gate``), both < 1e-3: max|x - 1| of the solve, and below
  ``REFERENCE_N`` the factor residual, at or above it max|x - 1| of
  ``solve_spd`` with b = A*1 from the stored lower half (under JAX's key
  ``factor_residual``).

Writes the JAX script's 14 keys (``ART_KEYS``) and the port's
(``EXTRA_KEYS``) to ``out.json`` (default ``large_run_torch.json``) and
prints them; a failed gate exits with "verification failed" after the
file is written.  Times are host seconds around calls that end in
``torch.cuda.synchronize()``.  The kernels' build stays out of every timer
(``kernel_build_s``), as in the bench.  JAX's ``cache_dir`` (compiled TPU
executables) has no counterpart.  There is no fallback: without CUDA the
default device raises before any line is printed.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from parsy_bench_tpu_torch import bench, native
from parsy_bench_tpu_torch.config import SolverConfig
from parsy_bench_tpu_torch.core import generate
from parsy_bench_tpu_torch.models import CholeskySolver
from parsy_bench_tpu_torch.ops import kernels
from parsy_bench_tpu_torch.ops.device import resolve_device

#: the n from which the run takes the scatter update mode, b = L*1 from the
#: pools on the device and the SPD-solve gate (the JAX script's 5e5)
REFERENCE_N = 500_000
GROUP = 8          # the JAX script's group at this scale
ROUNDS = 3         # timed factorizes and solve rounds
SOLVE_ITERS = 3    # solves per round
#: pool rows per masked sum (256 MB of f32 at c = 128)
CHUNK_ROWS = 1 << 19
DEFAULT_OUT = "large_run_torch.json"

#: the JAX script's keys, in its order
ART_KEYS = ("matrix", "n", "metric", "value", "unit", "vs_baseline",
            "factorize_s", "factor_residual", "trisolve_gnnz_per_s",
            "trisolve_residual", "analyze_s", "analyze_timings", "compile_s",
            "group")
#: the keys the port's line adds: the card's name and power limit
#: (``"cpu"`` on the CPU), the torch and CUDA versions, the update mode,
#: whether the native inspector library loaded, the kernels' build and
#: load seconds, the peak of allocated device memory (GB, null on the
#: CPU), K1's launches per factorize (the programs' captures, summed), the
#: plan's K1 calls per factorize, K1's launches over the whole run (the
#: wrapper's count: warm-up and capture of each program), the distinct
#: (P, c) batches the factorize gives K1, and each program's graph nodes
#: and capture seconds (null on the CPU)
EXTRA_KEYS = ("device", "torch", "cuda", "update_delta", "native_lib",
              "kernel_build_s", "peak_device_gb",
              "k1_launches_per_factorize", "chol_calls_per_factorize",
              "k1_launches_run", "k1_shapes", "graph_nodes", "capture_s")


def _stage(obj) -> None:
    print(json.dumps(obj), flush=True)


def analyze(grid: int, dev):
    """(A, the analyzed solver, analyze seconds); prints the stage line."""
    a = generate.laplace_3d(grid)
    t0 = time.perf_counter()
    upd = "gather" if a.n < REFERENCE_N else "scatter"
    solver = CholeskySolver(a, SolverConfig(ordering="nd", dtype="float32",
                                            tier="supernodal",
                                            update_delta=upd), device=dev)
    analyze_s = time.perf_counter() - t0
    plan = solver.plan
    _stage({"stage": "analyze", "s": round(analyze_s, 1),
            "timings": solver.timings, "segments": len(plan.segments),
            "gflop_true": round(plan.flops / 1e9, 1),
            "pool_mb": round(plan.pool_elems() * 4 / 1e6)})
    return a, solver, analyze_s


def factorize(solver, dev):
    """A's values uploaded once; the first ``factorize_segmented`` (the
    programs' capture and first run) sets ``solver.lx``; then ``ROUNDS``
    timed calls.  Returns (compile seconds, seconds of each call)."""
    ex = solver.executor
    data = torch.as_tensor(solver.ap.data.astype(np.float32), device=dev)
    bench._sync(dev)
    t0 = time.perf_counter()
    solver.lx = ex.factorize_segmented(data, group=GROUP)
    bench._sync(dev)
    compile_s = time.perf_counter() - t0
    _stage({"stage": "compile+first", "s": round(compile_s, 1)})
    times = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        lx = ex.factorize_segmented(data, group=GROUP)
        bench._sync(dev)
        times.append(time.perf_counter() - t0)
        del lx
    return compile_s, times


def row_map(plan, ci):
    """(global row, count) of each pool row of class ``ci``: the row of L
    it holds and how many of its leading columns are L's, min(intra + 1,
    w), which leaves out the ``Linv^T`` the finalize stores in each
    diagonal block's strict upper triangle.  Rows outside every panel map
    to row n with count 0."""
    lay = plan.layout
    w_all = np.diff(lay.part.sptr)
    h_all = np.diff(lay.rptr)
    sel = np.nonzero(lay.cls == ci)[0]
    h = h_all[sel]
    owner = np.repeat(np.arange(len(sel)), h)
    intra = np.arange(int(h.sum())) - np.repeat(np.cumsum(h) - h, h)
    pr = lay.rowoff[sel][owner] + intra
    nrows = int(plan.nrows[ci])
    gr = np.full(nrows, plan.n, dtype=np.int64)
    cnt = np.zeros(nrows, dtype=np.int32)
    gr[pr] = lay.rows[np.repeat(lay.rptr[sel], h) + intra]
    cnt[pr] = np.minimum(intra + 1, w_all[sel][owner])
    return gr, cnt


def pool_row_sums(solver) -> np.ndarray:
    """b = L*1 in f64 from the factor's pools on their device: per pool
    row, the sum of its first ``count`` entries (``row_map``) in the
    pools' dtype, accumulated into b in f64.  The masked temporary is
    taken ``CHUNK_ROWS`` rows of the (R, c) view at a time."""
    ex, plan = solver.executor, solver.plan
    dev = ex.device
    n = plan.n
    b = torch.zeros(n + 1, dtype=torch.float64, device=dev)
    for ci, c in enumerate(ex.classes):
        gr, cnt = row_map(plan, ci)
        rows = solver.lx[ci].view(-1, c)
        ar = torch.arange(c, device=dev)
        for r0 in range(0, rows.shape[0], CHUNK_ROWS):
            r1 = min(r0 + CHUNK_ROWS, rows.shape[0])
            k = torch.as_tensor(cnt[r0:r1], device=dev)
            s = torch.where(ar[None, :] < k[:, None], rows[r0:r1],
                            0).sum(dim=1)
            b.index_add_(0, torch.as_tensor(gr[r0:r1], device=dev),
                         s.to(torch.float64))
    return b[:n].cpu().numpy()


def ones_rhs(solver) -> np.ndarray:
    """b = L*1 in f32: from ``factor_csc()`` on the host below
    ``REFERENCE_N``, else from ``pool_row_sums`` on the device."""
    n = solver.a.n
    if n < REFERENCE_N:
        lmat = solver.factor_csc().to_scipy()
        return np.asarray(lmat @ np.ones(n), dtype=np.float32)
    return pool_row_sums(solver).astype(np.float32)


def solve(solver, b, dev):
    """One warm ``solve_loop(lx, b, SOLVE_ITERS)``, then ``ROUNDS`` timed
    rounds; returns (the warm call's x on the host, seconds per solve of
    each round)."""
    ex = solver.executor
    x = ex.solve_loop(solver.lx, b, SOLVE_ITERS)
    bench._sync(dev)
    stimes = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        ex.solve_loop(solver.lx, b, SOLVE_ITERS)
        bench._sync(dev)
        stimes.append((time.perf_counter() - t0) / SOLVE_ITERS)
    return x.cpu().numpy(), stimes


def spd_residual(solver) -> float:
    """max|x - 1| of ``solve_spd`` with b = A*1 from the stored lower half
    (A x = A*1 runs L, L^T and A's scatter without building L)."""
    import scipy.sparse as sp
    n = solver.a.n
    ap = solver.ap
    amat = sp.csc_matrix((ap.data, ap.indices, ap.indptr), shape=(n, n))
    full = amat + sp.tril(amat, -1).T
    ba = np.asarray(full @ np.ones(n, dtype=np.float32), dtype=np.float32)
    xs = solver.executor.solve_spd(solver.lx, ba).cpu().numpy()
    return float(np.max(np.abs(xs - 1.0)))


def gate(solver, x) -> tuple:
    """(the factor gate, max|x - 1|): the factor residual below
    ``REFERENCE_N``, else ``spd_residual``."""
    residual = (solver.factor_residual() if solver.a.n < REFERENCE_N
                else spd_residual(solver))
    return residual, float(np.max(np.abs(x - 1.0)))


def k1_launches(ex) -> int:
    """K1's launches per ``factorize_segmented(group=GROUP)``: the sum
    over its programs of the launches their captures recorded."""
    names = ["init"] + [f"segments[{lo}:{hi}]"
                        for lo, hi in ex.group_bounds(GROUP)]
    return sum(ex.programs[name].launches.get("cholesky_inverse_cuda", 0)
               for name in names)


def run(grid: int = 64, device="cuda") -> dict:
    """The run at ``laplace_3d(grid)`` on ``device``: the line's keys
    (``ART_KEYS`` then ``EXTRA_KEYS``) and values.  On the card it raises
    where K1's launches per factorize differ from the plan's calls."""
    dev = resolve_device(device)
    if dev.type == "cuda" and native.lib is None:
        raise RuntimeError("the native inspector library did not load: "
                           "analyze_s would time the numpy inspector")
    kernel_build_s = bench.build_kernels(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("float32 matmul precision is not 'highest'")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()

    a, solver, analyze_s = analyze(grid, dev)
    ex = solver.executor
    compile_s, times = factorize(solver, dev)
    median = sorted(times)[len(times) // 2]
    k1 = k1_launches(ex)
    if dev.type == "cuda" and k1 != ex.chol_calls_per_factorize:
        raise RuntimeError(f"K1 launched {k1} times per factorize; the "
                           f"plan implies {ex.chol_calls_per_factorize}")
    b = ones_rhs(solver)
    x, stimes = solve(solver, b, dev)
    smedian = sorted(stimes)[len(stimes) // 2]
    residual, solve_err = gate(solver, x)
    k1_run = kernels.cholesky_inverse_cuda.launches

    nnzl = int(solver.cc.sum())
    flops = solver.plan.flops
    ref_time = flops * bench._REF_SEC_PER_FLOP / bench._REF_THREADS
    progs = ex.programs
    return {
        "matrix": f"laplace_3d({grid})", "n": int(a.n),
        "metric": "supernodal_cholesky_factorize_gflops",
        "value": round(flops / median / 1e9, 4),
        "unit": "GFLOP/s",
        "vs_baseline": round(ref_time / median, 4),
        "factorize_s": [round(t, 4) for t in sorted(times)],
        "factor_residual": float(f"{residual:.3e}"),
        "trisolve_gnnz_per_s": round(nnzl / smedian / 1e9, 4),
        "trisolve_residual": float(f"{solve_err:.3e}"),
        "analyze_s": round(analyze_s, 1),
        "analyze_timings": solver.timings,
        "compile_s": round(compile_s, 1),
        "group": GROUP,
        "device": bench._card() if dev.type == "cuda" else "cpu",
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "update_delta": solver.config.update_delta,
        "native_lib": native.lib is not None,
        "kernel_build_s": kernel_build_s,
        "peak_device_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                           if dev.type == "cuda" else None),
        "k1_launches_per_factorize": k1,
        "chol_calls_per_factorize": ex.chol_calls_per_factorize,
        "k1_launches_run": k1_run,
        "k1_shapes": sorted([int(P), int(c)]
                            for P, c in ex.chol_batch_shapes()),
        "graph_nodes": {k: p.nodes for k, p in progs.items()},
        "capture_s": {k: p.capture_s for k, p in progs.items()},
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default=DEFAULT_OUT)
    ap.add_argument("grid", nargs="?", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    art = run(args.grid, args.device)
    print(json.dumps(art), flush=True)
    with open(args.out, "w") as f:
        json.dump(art, f, indent=1)
    if not (art["factor_residual"] < 1e-3
            and art["trisolve_residual"] < 1e-3):
        raise SystemExit("verification failed")
    print("wrote", args.out)


if __name__ == "__main__":
    main()
