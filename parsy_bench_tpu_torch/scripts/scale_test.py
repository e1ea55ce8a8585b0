"""Large-problem end-to-end test: the port's counterpart of
``scripts/scale_test.py`` (inspector time, capture time, table and pool
MB, factorize GFLOP/s, residual, trisolve rate).

    python -m parsy_bench_tpu_torch.scripts.scale_test [k] [ordering]
        [iters] [key=value ...] [--device cuda]

``laplace_3d(k)`` (48 by default), ``ordering`` (``nd``), ``iters`` (5)
factorizes per timed round, f32, supernodal tier, on the card unless
``--device cpu`` is given.  The knobs are the JAX script's
(``width_classes``, ``chunk_classes``, ``q_classes``, ``nrelax`` and
``zrelax`` as comma lists, ``alpha`` for ``segment_alpha``,
``max_width`` for ``max_supernode_width``, and ``segmented=1``, which
times ``factorize_segmented`` in place of ``factorize_loop``).

Prints the JAX script's two text lines and three JSON lines with its keys,
each JSON line with ``device`` beside them, and the first also with
``executor_table_MB``: the index tables the executor uploaded, beside the
plan's ``table_MB``.  As in JAX it has no gate: it reports the factor
residual and moves on.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from parsy_bench_tpu_torch import bench
from parsy_bench_tpu_torch.config import SolverConfig
from parsy_bench_tpu_torch.core import generate
from parsy_bench_tpu_torch.models import CholeskySolver
from parsy_bench_tpu_torch.ops.device import resolve_device


def parse(argv):
    """(k, ordering, iters, the SolverConfig keywords, segmented, device)
    from the JAX script's arguments, with ``--device X`` (or
    ``--device=X``) taken out first."""
    argv = list(argv)
    device = "cuda"
    for i, arg in enumerate(argv):
        if arg == "--device":
            device = argv[i + 1]
            del argv[i:i + 2]
            break
        if arg.startswith("--device="):
            device = arg.partition("=")[2]
            del argv[i]
            break
    k = int(argv[0]) if len(argv) > 0 else 48
    ordering = argv[1] if len(argv) > 1 else "nd"
    iters = int(argv[2]) if len(argv) > 2 else 5
    cfg_kw = {}
    for arg in argv[3:]:          # e.g. width_classes=128 alpha=1.6
        key, _, val = arg.partition("=")
        if key in ("width_classes", "chunk_classes", "q_classes",
                   "nrelax"):
            cfg_kw[key] = tuple(int(x) for x in val.split(","))
        elif key == "zrelax":
            cfg_kw[key] = tuple(float(x) for x in val.split(","))
        elif key == "alpha":
            cfg_kw["segment_alpha"] = float(val)
        elif key == "max_width":
            cfg_kw["max_supernode_width"] = int(val)
    segmented = "segmented=1" in argv[3:]
    return k, ordering, iters, cfg_kw, segmented, device


def config(ordering, cfg_kw) -> SolverConfig:
    return SolverConfig(ordering=ordering, dtype="float32",
                        tier="supernodal", **cfg_kw)


def _line(obj) -> None:
    print(json.dumps(obj), flush=True)


def run(k=48, ordering="nd", iters=5, cfg_kw=None, segmented=False,
        device="cuda") -> None:
    """The JAX script's run on ``device``; prints its lines."""
    dev = resolve_device(device)
    card = bench._card() if dev.type == "cuda" else "cpu"
    bench.build_kernels(dev)
    t0 = time.perf_counter()
    a = generate.laplace_3d(k)
    t_gen = time.perf_counter() - t0
    print(f"gen laplace_3d({k}): n={a.n} nnz={a.nnz} {t_gen:.1f}s",
          flush=True)

    t0 = time.perf_counter()
    solver = CholeskySolver(a, config(ordering, cfg_kw or {}), device=dev)
    t_analyze = time.perf_counter() - t0
    plan = solver.plan
    ex = solver.executor
    _line({
        "analyze_s": round(t_analyze, 1),
        "stage_timings": solver.timings,
        "nsuper": int(plan.layout.part.nsuper),
        "nlev": plan.nlev, "nseg": len(plan.segments),
        "flops_G": round(plan.flops / 1e9, 2),
        "gemm_padded_G": round(plan.gemm_flops / 1e9, 2),
        "table_MB": round(plan.table_bytes() / 1e6, 1),
        "pool_MB": round(plan.pool_elems() * 4 / 1e6, 1),
        "upd_buckets": sum(len(s.upd) for s in plan.segments),
        "fin_buckets": sum(len(s.fin) for s in plan.segments),
        "upd_lanes": int(sum(b.arow.shape[0] * s.nsteps * b.arow.shape[2]
                             for s in plan.segments for b in s.upd)),
        "executor_table_MB": round(ex.table_bytes / 1e6, 1),
        "device": card,
    })

    def factorize():
        if segmented:
            return ex.factorize_segmented(data)
        return ex.factorize_loop(data, iters)

    data = torch.as_tensor(solver.ap.data.astype(np.float32), device=dev)
    bench._sync(dev)
    t0 = time.perf_counter()
    solver.lx = factorize()
    bench._sync(dev)
    t_compile = time.perf_counter() - t0
    print(f"compile+first: {t_compile:.1f}s", flush=True)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        factorize()
        bench._sync(dev)
        times.append((time.perf_counter() - t0)
                     / (1 if segmented else iters))
    med = sorted(times)[1]
    res = solver.factor_residual()
    ref_s = plan.flops * bench._REF_SEC_PER_FLOP / bench._REF_THREADS
    _line({
        "factorize_s": round(med, 4),
        "gflops": round(plan.flops / med / 1e9, 1),
        "vs_baseline": round(ref_s / med, 3),
        "residual": float(res),
        "device": card,
    })

    # blocked trisolve (BASELINE.md second headline metric)
    bp = np.asarray(solver.ap.spd_rhs_for_ones(), dtype=np.float32)
    t0 = time.perf_counter()
    ex.solve_loop(solver.lx, bp, iters)
    bench._sync(dev)
    t_sc = time.perf_counter() - t0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        ex.solve_loop(solver.lx, bp, iters)
        bench._sync(dev)
        times.append((time.perf_counter() - t0) / iters)
    smed = sorted(times)[1]
    nnzl = int(solver.cc.sum())
    _line({
        "solve_compile_s": round(t_sc, 1),
        "trisolve_s": round(smed, 5),
        "trisolve_gnnz_per_s": round(nnzl / smed / 1e9, 3),
        "device": card,
    })


def main(argv=None) -> None:
    k, ordering, iters, cfg_kw, segmented, device = parse(
        sys.argv[1:] if argv is None else argv)
    run(k, ordering, iters, cfg_kw, segmented, device)


if __name__ == "__main__":
    main()
