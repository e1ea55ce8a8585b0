"""Cholesky H1-vs-coarsened schedule comparison: the port's counterpart of
``scripts/h1_vs_coarse.py`` (the reference's choleskyTest03 wavefront
baseline against choleskyTest LBC, choleskyTest03.cpp:46 /
InspectionLevel_06.h:18).

    python -m parsy_bench_tpu_torch.scripts.h1_vs_coarse [grid] [ordering]
        [--out h1_vs_coarse_torch.jsonl] [--device cuda]

``segment_alpha`` sets the coarsening of the level steps into segments:
alpha <= 1 gives one segment per wavefront level (plain H1), larger alpha
merges levels into padded multi-step segments.  For each alpha of
``ALPHAS`` on ``laplace_3d(grid)`` (24 by default, ``ordering`` nd), f32,
supernodal tier, the JAX script's protocol: analyze; the first
``factorize_loop(data, ITERS)`` is ``compile_s`` (on the card the capture
of the ``factorize`` program and its first replays); the median of
``ROUNDS`` timed loops, each between ``torch.cuda.synchronize()`` calls,
per factorize; the factor residual of the last loop's factor.

Each row holds the JAX row's keys (``ROW_KEYS``, rounded as JAX rounds
them) and ``EXTRA_KEYS``: the card's name and power limit (``"cpu"`` on
the CPU) and K1's launches per factorize, read from the ``factorize``
program's capture (0 on the CPU, where the plain version runs); on the
card a count other than the plan's K1 calls raises.  Rows are printed and
appended to ``--out`` (``h1_vs_coarse_torch.jsonl`` by default).  Without
CUDA the default device raises before any row.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from parsy_bench_tpu_torch import bench
from parsy_bench_tpu_torch.config import SolverConfig
from parsy_bench_tpu_torch.core import generate
from parsy_bench_tpu_torch.models import CholeskySolver
from parsy_bench_tpu_torch.ops.device import resolve_device

ALPHAS = (1.0, 1.25, 1.6, 2.5)
ITERS = 5
ROUNDS = 3
DEFAULT_OUT = "h1_vs_coarse_torch.jsonl"
#: the JAX script's row keys, in its order
ROW_KEYS = ("matrix", "n", "ordering", "segment_alpha", "schedule",
            "segments", "nlev", "factorize_s", "gflops", "compile_s",
            "analyze_s", "table_MB", "residual")
EXTRA_KEYS = ("device", "k1_launches_per_factorize")


def config(ordering: str, alpha: float) -> SolverConfig:
    return SolverConfig(ordering=ordering, dtype="float32",
                        tier="supernodal", segment_alpha=alpha)


def row(a, grid: int, ordering: str, alpha: float, dev, card) -> dict:
    """One alpha's row (module docstring) on ``dev``."""
    t0 = time.perf_counter()
    s = CholeskySolver(a, config(ordering, alpha), device=dev)
    analyze_s = time.perf_counter() - t0
    ex = s.executor
    data = torch.as_tensor(s.ap.data.astype(np.float32), device=dev)
    bench._sync(dev)
    t0 = time.perf_counter()
    s.lx = ex.factorize_loop(data, ITERS)
    bench._sync(dev)
    compile_s = time.perf_counter() - t0
    ts = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        s.lx = ex.factorize_loop(data, ITERS)
        bench._sync(dev)
        ts.append((time.perf_counter() - t0) / ITERS)
    med = sorted(ts)[len(ts) // 2]
    k1 = ex.programs["factorize"].launches.get("cholesky_inverse_cuda", 0)
    if dev.type == "cuda" and k1 != ex.chol_calls_per_factorize:
        raise RuntimeError(f"alpha {alpha}: K1 launched {k1} times per "
                           f"factorize; the plan implies "
                           f"{ex.chol_calls_per_factorize}")
    return {
        "matrix": f"laplace_3d({grid})", "n": int(a.n),
        "ordering": ordering, "segment_alpha": alpha,
        "schedule": "wavefront-H1" if alpha <= 1.0 else "coarsened",
        "segments": len(s.plan.segments), "nlev": s.plan.nlev,
        "factorize_s": round(med, 4),
        "gflops": round(s.plan.flops / med / 1e9, 2),
        "compile_s": round(compile_s, 1),
        "analyze_s": round(analyze_s, 1),
        "table_MB": round(s.plan.table_bytes() / 1e6, 1),
        "residual": float(f"{s.factor_residual():.3e}"),
        "device": card,
        "k1_launches_per_factorize": int(k1),
    }


def run(grid: int = 24, ordering: str = "nd", device="cuda",
        out_path: str = DEFAULT_OUT) -> list[dict]:
    """Every alpha's row on ``device``, each printed and appended to
    ``out_path`` as it comes."""
    dev = resolve_device(device)
    bench.build_kernels(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = bench._card() if dev.type == "cuda" else "cpu"
    a = generate.laplace_3d(grid)
    rows = []
    with open(out_path, "a") as out:
        for alpha in ALPHAS:
            r = row(a, grid, ordering, alpha, dev, card)
            print(json.dumps(r), flush=True)
            out.write(json.dumps(r) + "\n")
            out.flush()
            rows.append(r)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("grid", nargs="?", type=int, default=24)
    ap.add_argument("ordering", nargs="?", default="nd")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.grid, args.ordering, args.device, args.out)


if __name__ == "__main__":
    main()
