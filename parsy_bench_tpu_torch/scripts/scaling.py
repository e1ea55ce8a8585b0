"""Multi-device scaling artifact: the port's counterpart of
``scripts/scaling.py``.

    python -m parsy_bench_tpu_torch.scripts.scaling [grid] [out.json]
        [--device cpu]

Runs the ownership-partitioned distributed factorize and solve
(``parallel/dist.py``: per-rank pools, boundary-only ``psum``) at
G in {1, 2, 4, 8} on ``laplace_3d(grid)`` (48 by default, n = 110,592),
on the card unless ``--device cpu`` is given, and writes the JAX script's
artifact to ``out.json`` (default ``scaling_torch.json``).  The JAX
script's configuration: nested dissection, f32, supernodal,
``update_delta="scatter"`` (the distributed executor always scatters, so
G = 1 does too), ``factorize_segmented(data32, group=8)`` timed, the
solve ``solve_lower`` with b = A*1 (``spd_rhs_for_ones``).

* G = 1 runs in this process on the solver's executor, whose programs are
  captured CUDA graphs on the card (``single_row``).
* G > 1 runs ``DistExecutor`` on ``build_dist_plan(ap, parent, cc, G,
  cfg)`` in G fresh rank processes (``parallel/comm.launch`` of
  ``parallel/runs.run_dist``), laid out by ``comm.rank_layout``: NCCL
  with one card per rank where the machine has G cards, else gloo with
  every rank on the first card (``rank_row``).

The JAX protocol: one untimed first call, whose seconds are
``compile_s`` (at G = 1 the warm-up and the graphs' capture; at G > 1 the
ranks' first factorize, op by op, which captures nothing), then the
median of 3 synchronized calls, for the factorize and for the solve.
On the card each rank also profiles one factorize through the one
profiler (``scripts/attribution.profile``), so the row holds each rank's
device busy ms (None on the CPU: not measured) and K1 launches.

A row has the JAX row's keys (``ROW_KEYS``), with the JAX meaning, then
the port's (``EXTRA_KEYS``): the ranks' ``backend`` and the distinct
devices they used (``cards``; the CPU counts as one), rank 0's all_reduce
payload in one factorize (``psum_payload_bytes``), the efficiency against
the cards the ranks had (``efficiency_vs_card_ceiling`` = t1 / (min(G,
cards) tG)), each rank's K1 launches, the plan's K1 calls, each rank's
busy ms and whether each rank held no module of JAX.  Numbers are not
rounded.  The one check, as in ``chip_smoke.py``: the ring bytes of the
measured payload, 2 (G - 1) / G times it, equal the plan's modelled
``factorize_bytes`` (``ring_check``); a miss raises.  The bytes per rank
(pool, psum) are properties of the plan and do not depend on where it
runs.  There is no fallback: without CUDA the default device raises.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from parsy_bench_tpu_torch import bench
from parsy_bench_tpu_torch.config import SolverConfig
from parsy_bench_tpu_torch.core import generate
from parsy_bench_tpu_torch.models import CholeskySolver
from parsy_bench_tpu_torch.ops.device import resolve_device
from parsy_bench_tpu_torch.parallel import comm, runs
from parsy_bench_tpu_torch.scripts import attribution, large_run
from parsy_bench_tpu_torch.symbolic.dplan import build_dist_plan

GROUPS = (1, 2, 4, 8)
GROUP = 8          # factorize_segmented's group, the JAX script's
REPS = 3           # timed calls after the first
LAUNCH_TIMEOUT = 600.0
DEFAULT_OUT = "scaling_torch.json"
#: the JAX row's keys, in its order (scripts/scaling.py:103-112, 141-143)
ROW_KEYS = ("g", "n", "nnz_l", "cores", "factorize_s", "solve_s",
            "compile_s", "factorize_mnnz_per_s",
            "psum_bytes_per_device_per_factorize", "solve_psum_bytes",
            "pool_bytes_per_device", "cross_row_fraction",
            "efficiency_vs_g1", "efficiency_vs_core_ceiling")
#: the port's keys after them (the module docstring)
EXTRA_KEYS = ("backend", "cards", "psum_payload_bytes",
              "efficiency_vs_card_ceiling", "k1_launches",
              "chol_calls_per_factorize", "device_busy_ms", "jax_free")
#: the JAX artifact's keys, then the card's name and power limit
ART_KEYS = ("matrix", "n", "backend", "design", "caveat", "rows", "card")
#: the solve-side payloads the JAX row keeps from ``psum_bytes_per_step``
SOLVE_PSUM_KEYS = ("solve_lower_bytes", "solve_upper_bytes",
                   "solve_r4_design_bytes", "receive_min_bytes")


def config() -> SolverConfig:
    return SolverConfig(ordering="nd", dtype="float32", tier="supernodal",
                        update_delta="scatter")


def plan_keys(plan) -> dict:
    """The row's architecture keys, properties of the plan: the modelled
    all_reduce bytes per rank of one factorize and of the solves, the pool
    bytes per rank (f32) and the share of boundary rows.  ``plan`` is the
    single-device ``SupernodalPlan`` at G = 1, a ``DistPlan`` above."""
    if not hasattr(plan, "psum_bytes_per_step"):
        return dict(psum_bytes_per_device_per_factorize=0.0,
                    solve_psum_bytes={},
                    pool_bytes_per_device=plan.pool_elems() * 4,
                    cross_row_fraction=0.0)
    pm = plan.psum_bytes_per_step()
    return dict(psum_bytes_per_device_per_factorize=pm["factorize_bytes"],
                solve_psum_bytes={k: pm[k] for k in SOLVE_PSUM_KEYS},
                pool_bytes_per_device=plan.pool_elems_per_device() * 4,
                cross_row_fraction=plan.comm["row_fraction_cross"])


def ring_check(plan, payload_bytes) -> float:
    """The ring bytes of one factorize's measured all_reduce payload, 2
    (G - 1) / G times it; raises where they differ from the plan's
    ``factorize_bytes``."""
    ring = payload_bytes * 2.0 * (plan.G - 1) / plan.G
    model = plan.psum_bytes_per_step()["factorize_bytes"]
    if ring != model:
        raise AssertionError(f"G = {plan.G}: all_reduce ring bytes {ring} "
                             f"per factorize, the plan models {model}")
    return ring


def _median(ts):
    return sorted(ts)[len(ts) // 2]


def analyze(grid: int, dev) -> CholeskySolver:
    return CholeskySolver(generate.laplace_3d(grid), config(), device=dev)


def rhs(solver) -> np.ndarray:
    """The JAX script's solve input: b = A*1 of the permuted matrix, f32."""
    return np.asarray(solver.ap.spd_rhs_for_ones(), dtype=np.float32)


def _base(solver, g) -> dict:
    return dict(g=g, n=int(solver.a.n), nnz_l=int(solver.cc.sum()),
                cores=os.cpu_count() or 1)


def single_row(solver, dev) -> dict:
    """The G = 1 row in this process, on ``solver``'s executor (the
    scatter update mode): the first ``factorize_segmented(group=8)``
    (``compile_s``), the median of 3 more, ``solve_lower`` once untimed and
    the median of 3, and on the card one factorize's device busy ms
    through the profiler.  Leaves the factor in ``solver.lx``."""
    ex = solver.executor
    data = torch.as_tensor(solver.ap.data.astype(np.float32), device=dev)
    b = rhs(solver)

    def fact():
        return ex.factorize_segmented(data, group=GROUP)

    compile_s, _ = runs._timed(dev, fact)
    tf = _median([runs._timed(dev, fact)[0] for _ in range(REPS)])
    solver.lx = fact()
    ex.solve_lower(solver.lx, b)
    ts = _median([runs._timed(dev, lambda: ex.solve_lower(solver.lx, b))[0]
                  for _ in range(REPS)])
    busy = None
    if dev.type == "cuda":
        evs, _, _ = attribution.profile(fact, dev)
        busy = sum(m for _, m in attribution._work(evs, dev)) or None
    row = _base(solver, 1)
    row.update(factorize_s=tf, solve_s=ts, compile_s=compile_s,
               factorize_mnnz_per_s=row["nnz_l"] / tf / 1e6,
               **plan_keys(solver.plan))
    row.update(backend=None, cards=1, psum_payload_bytes=0,
               k1_launches=[large_run.k1_launches(ex)],
               chol_calls_per_factorize=ex.chol_calls_per_factorize,
               device_busy_ms=[busy],
               jax_free=[runs._jax_free()])
    return row


def rank_job(plan, solver, dev) -> tuple:
    """The job of each rank of G > 1 (``runs.run_dist``): the JAX data
    and solve input, 3 timed ``factorize_segmented(group=8)`` and
    ``solve_lower``, on the card the first factorize profiled."""
    return ("dist", dict(plan=plan, a_data=solver.ap.data.astype(np.float32),
                         dtype="float32", solves={"solve_lower": rhs(solver)},
                         reps=REPS, profile=dev.type == "cuda",
                         time_group=GROUP))


def rank_row(plan, solver, recs) -> dict:
    """The row of G = ``plan.G`` from its ranks' records (``run_dist``
    with ``time_group=8``): rank 0's medians, the ranks' first factorize
    as ``compile_s``, the plan's architecture keys, the ring check."""
    r0 = recs[0]
    if r0.get("timed") != f"factorize_segmented({GROUP})":
        raise ValueError(f"the ranks timed {r0.get('timed')!r}, not "
                         f"factorize_segmented({GROUP})")
    tf = _median(r0["factorize_s"])
    row = _base(solver, plan.G)
    row.update(factorize_s=tf,
               solve_s=_median(r0["solve_s"]["solve_lower"]),
               compile_s=r0["first_factorize_s"],
               factorize_mnnz_per_s=row["nnz_l"] / tf / 1e6,
               **plan_keys(plan))
    ring_check(plan, r0["psum_bytes"])
    row.update(backend=r0["backend"],
               cards=len({r["device"] for r in recs}),
               psum_payload_bytes=r0["psum_bytes"],
               k1_launches=[r["k1_launches"] for r in recs],
               chol_calls_per_factorize=r0["chol_calls_per_factorize"],
               device_busy_ms=[r.get("device_busy_ms") for r in recs],
               jax_free=[r["jax_free"] for r in recs])
    return row


def with_efficiency(row, t1) -> dict:
    """``row`` with the JAX script's two efficiencies against the G = 1
    factorize time ``t1`` (scripts/scaling.py:141-143) and the port's
    against its cards, its keys in ``ROW_KEYS + EXTRA_KEYS`` order."""
    g, tg = row["g"], row["factorize_s"]
    out = dict(row, efficiency_vs_g1=t1 / (g * tg),
               efficiency_vs_core_ceiling=t1 / (min(g, row["cores"]) * tg),
               efficiency_vs_card_ceiling=t1 / (min(g, row["cards"]) * tg))
    return {k: out[k] for k in ROW_KEYS + EXTRA_KEYS}


def artifact(grid, solver, rows, card) -> dict:
    """The JAX artifact's keys (``ART_KEYS``), its caveat written for the
    ranks' layout."""
    cores = os.cpu_count() or 1
    ranks = [r for r in rows if r["g"] > 1]
    backends = sorted({r["backend"] for r in ranks})
    cards = max((r["cards"] for r in ranks), default=1)
    on_cpu = card == "cpu"
    where = f"the CPU ({cores} cores)" if on_cpu else card
    backend = (f"{'/'.join(backends) or 'none'} ranks on {cards} "
               f"device(s): {where}; G = 1 in one process")
    if on_cpu:
        caveat = (f"the ranks share one {cores}-core host: wall-clock "
                  f"speedup is capped at min(G, cores); psum/pool bytes "
                  f"per rank are properties of the plan")
    elif "gloo" in backends:
        caveat = ("gloo ranks time-slice one card and their all_reduce "
                  "goes through the host: a wall-clock speedup is no "
                  "multi-GPU figure; psum/pool bytes per rank are "
                  "properties of the plan")
    else:
        caveat = ("one card per rank, NCCL all_reduce; psum/pool bytes "
                  "per rank are properties of the plan")
    return dict(
        matrix=f"laplace_3d({grid})",
        n=int(solver.a.n), backend=backend,
        design="ownership-partitioned pools + ragged boundary psum; "
               "solves exchange boundary slots only, one final x "
               "assembly psum (parallel/dist.py)",
        caveat=caveat, rows=rows, card=card)


def run(grid: int = 48, device="cuda", groups=GROUPS,
        timeout: float = LAUNCH_TIMEOUT) -> dict:
    """The artifact at ``laplace_3d(grid)`` on ``device``, a row per G of
    ``groups`` (G = 1 first, the efficiencies' base); prints each row."""
    dev = resolve_device(device)
    bench.build_kernels(dev)
    card = bench._card() if dev.type == "cuda" else "cpu"
    solver = analyze(grid, dev)
    rows, t1 = [], None
    for g in groups:
        if g == 1:
            row = single_row(solver, dev)
        else:
            plan = build_dist_plan(solver.ap, solver.parent, solver.cc, g,
                                   solver.config)
            backend, devices = comm.rank_layout(g, dev)
            res = comm.launch(runs.run_jobs, g, backend, devices,
                              ([rank_job(plan, solver, dev)],),
                              timeout=timeout)
            row = rank_row(plan, solver, [ranks[0] for ranks in res])
        if t1 is None:
            t1 = row["factorize_s"]
        rows.append(with_efficiency(row, t1))
        print(json.dumps(rows[-1]), flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return artifact(grid, solver, rows, card)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("grid", nargs="?", type=int, default=48)
    ap.add_argument("out", nargs="?", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    art = run(args.grid, args.device)
    with open(args.out, "w") as f:
        json.dump(art, f, indent=1)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
