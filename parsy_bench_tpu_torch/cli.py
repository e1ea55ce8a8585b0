"""Benchmark drivers of the PyTorch port — the counterpart of
``parsy_bench_tpu/cli.py``, with the same subcommands, arguments, JSON keys
and protocol, on the card by default:

    python -m parsy_bench_tpu_torch.cli cholesky gen:laplace3d:20 --verify
    python -m parsy_bench_tpu_torch.cli trisolve gen:laplace3d:20
    python -m parsy_bench_tpu_torch.cli trisolve L.mtx --lower \\
        --schedule coarsened
    python -m parsy_bench_tpu_torch.cli baseline gen:laplace3d:20
    python -m parsy_bench_tpu_torch.cli lowerhalf full.mtx lower.mtx

``cholesky`` plays choleskyTest01 (examples/choleskyTest01.cpp): read or
generate -> analyze -> ``--iters`` timed numeric factorizations -> median
and verification, printed as one JSON line.  ``trisolve`` mirrors
triangularTest02.cpp: factor once (simplicial tier, f64), then time the
triangular solve on the real factor, verified with the b = L*1 all-ones
check (common/Util.h:261-306); ``--lower`` takes the input matrix itself
as a general (possibly non-chordal) lower-triangular L
(triangularTest_DAG_nonChordal.cpp).  ``baseline`` times scipy's SuperLU
and triangular solve the way libExample/ times MKL; ``lowerhalf`` is
MakingLowerHalf.cpp.

``--device`` (default ``cuda``) names the device of the numeric phase;
there is no fallback to the CPU.  Times are host seconds around calls that
end in ``torch.cuda.synchronize()`` on the card.  The first timed call
captures the executor's program (``compile_s``), as a JAX program compiles
once.  ``cholesky --profile`` adds the performance model's summary of the
plan (``utils/perfmodel.factorize_cost``, under the card's fitted
``ChipModel``) as ``model``; ``trisolve`` accepts ``--profile`` and
changes nothing, as in the JAX driver.

Matrix specs: a MatrixMarket path, or ``gen:<kind>:<size>`` with kinds
laplace2d / laplace3d / femgrid / randspd (``core/generate.py``).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def load_matrix(spec: str):
    from parsy_bench_tpu_torch.core import generate, io
    if spec.startswith("gen:"):
        _, kind, size = spec.split(":")
        n = int(size)
        if kind == "laplace2d":
            return generate.laplace_2d(n)
        if kind == "laplace3d":
            return generate.laplace_3d(n)
        if kind == "femgrid":
            return generate.fem_grid(n, n, dof=3, seed=0)
        if kind == "randspd":
            return generate.random_spd(n, density=0.004, band=4, seed=0)
        raise SystemExit(f"unknown generator {kind}")
    return io.read_matrix_market(spec)


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cmd_cholesky(args) -> None:
    from parsy_bench_tpu_torch.config import SolverConfig
    from parsy_bench_tpu_torch.models import CholeskySolver

    a = load_matrix(args.matrix)
    ordering, given = args.ordering, None
    if args.ordering_file:
        from parsy_bench_tpu_torch.core.io import read_ordering
        ordering, given = "given", read_ordering(args.ordering_file, a.n)
    cfg = SolverConfig(ordering=ordering, given_perm=given,
                       dtype=args.dtype, tier=args.tier,
                       max_supernode_width=args.max_width)
    t0 = time.perf_counter()
    s = CholeskySolver(a, cfg, device=args.device)
    analyze_s = time.perf_counter() - t0
    data = s.ap.data.astype(np.float32 if args.dtype == "float32"
                            else np.float64)
    t0 = time.perf_counter()
    s.factorize()
    _sync(s.device)
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        s.executor.factorize(data)
        _sync(s.device)
        times.append(time.perf_counter() - t0)
    med = sorted(times)[len(times) // 2]
    out = {
        "driver": "cholesky",
        "matrix": args.matrix,
        "n": a.n, "nnz_a": a.nnz,
        "tier": args.tier, "ordering": args.ordering, "dtype": args.dtype,
        "analyze_s": round(analyze_s, 4),
        "compile_s": round(compile_s, 3),
        "factorize_median_s": round(med, 6),
        "iters": args.iters,
        "device": str(s.device),
    }
    if args.tier == "supernodal":
        out["update_delta"] = cfg.update_delta
        out["gflops"] = round(s.plan.flops / med / 1e9, 3)
        out["nlev"] = s.plan.nlev
        out["nsuper"] = s.plan.layout.part.nsuper
        out["table_mb"] = round(s.plan.table_bytes() / 1e6, 1)
        out["pool_mb"] = round(s.plan.pool_elems() * 4 / 1e6, 1)
        if args.profile:
            from parsy_bench_tpu_torch.utils.perfmodel import factorize_cost
            out["model"] = factorize_cost(s.plan).summary()
    if args.verify:
        out["factor_residual"] = float(s.factor_residual())
        b = a.spd_rhs_for_ones()
        x = s.solve(b)
        out["solve_residual"] = float(s.solve_residual(b, x))
    print(json.dumps(out))


def cmd_trisolve(args) -> None:
    from parsy_bench_tpu_torch.config import SolverConfig
    from parsy_bench_tpu_torch.core.csc import (check_triangular,
                                                rhs_init_trisolve)
    from parsy_bench_tpu_torch.models import CholeskySolver, TriangularSolver

    a = load_matrix(args.matrix)
    if args.lower:
        # the input IS the (general, possibly non-chordal) lower factor —
        # reference triangularTest_DAG_nonChordal.cpp:40
        l = a if a.is_lower() else a.lower_half()
        if np.any(l.to_scipy().diagonal() == 0):
            raise SystemExit("lower-triangular input needs a full diagonal")
    else:
        l = CholeskySolver(a, SolverConfig(
            ordering=args.ordering, dtype="float64", tier="simplicial"),
            device=args.device).factorize().factor_csc()
    t0 = time.perf_counter()
    ts = TriangularSolver(l, SolverConfig(
        dtype=args.dtype, tier=args.tier, trisolve_schedule=args.schedule),
        device=args.device)
    analyze_s = time.perf_counter() - t0
    b = rhs_init_trisolve(l)
    x = ts.solve(b)   # capture + warm
    times = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        ts.executor.solve_lower(ts._lx, b)
        _sync(ts.device)
        times.append(time.perf_counter() - t0)
    med = sorted(times)[len(times) // 2]
    print(json.dumps({
        "driver": "trisolve",
        "matrix": args.matrix, "n": l.n, "nnz_l": l.nnz,
        "tier": args.tier, "dtype": args.dtype,
        "analyze_s": round(analyze_s, 4),
        "solve_median_s": round(med, 6),
        "nnz_per_s": round(2 * l.nnz / med, 1),
        "nlev": int(ts.nlev),
        "schedule": getattr(ts, "schedule", args.tier),
        "steps": (int(ts.plan.nsteps)
                  if hasattr(ts.plan, "nsteps") else int(ts.nlev)),
        "verified": bool(check_triangular(x)),
        "device": str(ts.device),
    }))


def cmd_baseline(args) -> None:
    """Competitor-library benchmark on the host — the libExample/ role
    (cholesky_mkl.cpp, triangular_MKL_Chol.cpp) with scipy SuperLU
    (``splu``) as the direct solver and scipy's triangular solve as the
    trsv.  Same protocol: analyze once, N timed numeric runs, median."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    if args.iters < 1:
        raise SystemExit("--iters must be >= 1")
    a = load_matrix(args.matrix)
    full = a.symmetrize_from_lower().to_scipy().tocsc()
    out = {"driver": "baseline", "matrix": args.matrix,
           "n": a.n, "nnz_a": a.nnz, "iters": args.iters}

    lu = spla.splu(full)  # warm (symbolic + numeric)
    times = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        lu = spla.splu(full)
        times.append(time.perf_counter() - t0)
    out["splu_factorize_median_s"] = round(sorted(times)[len(times) // 2], 6)
    b = a.spd_rhs_for_ones()
    x = lu.solve(b)
    out["splu_residual"] = float(np.linalg.norm(full @ x - b)
                                 / np.linalg.norm(b))

    ltri = sp.tril(full, 0).tocsr()
    bl = np.asarray(ltri @ np.ones(a.n))
    spla.spsolve_triangular(ltri, bl, lower=True)  # warm
    times = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        xt = spla.spsolve_triangular(ltri, bl, lower=True)
        times.append(time.perf_counter() - t0)
    med = sorted(times)[len(times) // 2]
    out["trsv_median_s"] = round(med, 6)
    out["trsv_nnz_per_s"] = round(2 * ltri.nnz / med, 1)
    out["trsv_verified"] = bool(np.all(np.abs(1.0 - xt) < 1e-3))
    print(json.dumps(out))


def cmd_lowerhalf(args) -> None:
    """Full symmetric MatrixMarket -> lower-half MatrixMarket (reference:
    examples/MakingLowerHalf.cpp:9)."""
    from parsy_bench_tpu_torch.core import io
    a = load_matrix(args.matrix)
    io.write_matrix_market(args.out, a if a.is_lower() else a.lower_half())
    print(json.dumps({"driver": "lowerhalf", "matrix": args.matrix,
                      "out": args.out, "n": a.n, "nnz_lower": a.nnz}))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="parsy_bench_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in [("cholesky", cmd_cholesky), ("trisolve", cmd_trisolve)]:
        q = sub.add_parser(name)
        q.add_argument("matrix")
        q.add_argument("--ordering", default="amd")
        q.add_argument("--ordering-file", default=None,
                       help="PaStiX-format permutation file (reference: "
                            "choleskyTest01.cpp:81, common/Util.h:187)")
        q.add_argument("--tier", default="supernodal",
                       choices=["simplicial", "supernodal"])
        q.add_argument("--dtype", default="float32")
        q.add_argument("--max-width", type=int, default=128,
                       help="supernode width cap (panel-chain split above)")
        q.add_argument("--iters", type=int, default=5)
        q.add_argument("--verify", action="store_true")
        q.add_argument("--profile", action="store_true",
                       help="cholesky: add the performance model's "
                            "summary of the plan")
        q.add_argument("--device", default="cuda",
                       help="device of the numeric phase: cuda (default), "
                            "cuda:<i> or cpu")
        if name == "trisolve":
            q.add_argument("--schedule", default="auto",
                           choices=["auto", "wavefront", "coarsened"],
                           help="general-DAG trisolve schedule: H1 "
                                "wavefront vs coarsened dense windows "
                                "(DAG-LBC replacement); auto = cost model")
            q.add_argument("--lower", action="store_true",
                           help="input matrix IS the lower-triangular L "
                                "(general non-chordal DAG path)")
        q.set_defaults(fn=fn)
    q = sub.add_parser("baseline")
    q.add_argument("matrix")
    q.add_argument("--iters", type=int, default=5)
    q.set_defaults(fn=cmd_baseline)
    q = sub.add_parser("lowerhalf")
    q.add_argument("matrix")
    q.add_argument("out")
    q.set_defaults(fn=cmd_lowerhalf)
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
