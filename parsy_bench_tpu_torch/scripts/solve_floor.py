"""Blocked-trisolve floor attribution: the port's counterpart of
``scripts/solve_floor.py``.

    python -m parsy_bench_tpu_torch.scripts.solve_floor [--ks 12,20,27,34]
        [--top 8192] [--grid 48] [--device cuda]

Times the fast forward solve (``SupernodalExecutor.solve_loop``: the
pair-granular ``_solve_lower_fast_impl``) on a factor of the scripts' own
executor (``factorize_segmented(group=16)``, as ``bench.py``), whole and
with its level steps truncated to the segment prefixes [0, k)
(``truncated``: the cumulative per-segment split), and optionally on a
plan whose dense top absorbs the thin root levels (``--top``, the plan's
``dense_top_cols``).  Each time is the median of 3 rounds of
``solve_loop(lx, b, 5)`` per solve, CUDA events on the card.  Truncated
solves give a wrong x (timing only); with b = L*1 the full solve must give
max|1 - x| < 1e-3, and ``run`` raises where it does not.  There is no AOT
cache (the JAX executor's ``cache_dir`` has no counterpart).

The line holds the JAX keys (``n``, ``full_s``, ``full_err``; ``prefix_s``
with ``--ks``; ``top_s``, ``top_err``, ``top_t``, ``top_nseg`` with
``--top``) and ``card``.  No number is rounded.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json

import numpy as np
import torch

from parsy_bench_tpu_torch import bench
from parsy_bench_tpu_torch.models import CholeskySolver
from parsy_bench_tpu_torch.ops.device import require, resolve_device
from parsy_bench_tpu_torch.scripts import attribution

_ITERS = 5
_ROUNDS = 3
_GROUP = 16


@contextlib.contextmanager
def truncated(ex, k):
    """The fast forward solve of ``ex`` stopped after the level steps of
    segments [0, min(k, nseg)): the counterpart of the JAX script's
    ``plan.solve_nseg = k`` with the compiled loop dropped.  Every segment
    has its solve tables and the slab pool (when on) has a slab set for
    each of the first ``_solve_nseg`` segments at construction, so k may
    not pass that count."""
    nseg0 = ex._solve_nseg
    k = min(int(k), len(ex.plan.segments))
    require(1 <= k <= nseg0, f"solve prefix {k} outside [1, {nseg0}]")
    ex._solve_nseg = k
    ex.programs.pop("solve_lower_fast", None)
    try:
        yield
    finally:
        ex._solve_nseg = nseg0
        ex.programs.pop("solve_lower_fast", None)


def factor(solver, ex):
    """(pools, b = L*1 on the device) of ``ex``'s ``factorize_segmented``
    on the solver's A values."""
    import scipy.sparse as sp
    lx = ex.factorize_segmented(attribution.a_values(ex, solver),
                                group=_GROUP)
    lpat, n = solver.lpat, solver.a.n
    lmat = sp.csc_matrix((ex.factor_values(lx).cpu().numpy().astype(
        np.float64), lpat.indices, lpat.indptr), shape=(n, n))
    return lx, torch.as_tensor(lmat @ np.ones(n)).to(device=ex.device,
                                                     dtype=ex.dtype)


def solve_s(ex, lx, b) -> float:
    """Seconds per forward solve: median of ``_ROUNDS`` rounds of
    ``solve_loop(lx, b, _ITERS)`` after one (its capture)."""
    ex.solve_loop(lx, b, _ITERS)
    ts = [attribution._reps_s(ex.device,
                              lambda: ex.solve_loop(lx, b, _ITERS), 1)
          / _ITERS for _ in range(_ROUNDS)]
    return sorted(ts)[len(ts) // 2]


def _checked(ex, lx, b, what) -> float:
    err = float((ex.solve_lower(lx, b) - 1).abs().max())
    if not err < 1e-3:
        raise SystemExit(f"{what}: max|1 - x| {err:.3e} >= 1e-3")
    return err


def run(solver, device="cuda", ks=(), top=0) -> dict:
    """The solve attribution on ``solver``'s plan (an executor of its own
    on ``device``) and, with ``top``, on a second analyze of its matrix
    with ``dense_top_cols=top``: the line's keys (module docstring)."""
    dev = resolve_device(device)
    ex = attribution.own_executor(solver, dev)
    lx, b = factor(solver, ex)
    out = {"n": int(ex.plan.n), "full_s": solve_s(ex, lx, b),
           "full_err": _checked(ex, lx, b, "full solve")}
    if ks:
        pref = {}
        for k in ks:
            with truncated(ex, k):
                pref[k] = solve_s(ex, lx, b)
        out["prefix_s"] = pref
    if top:
        s2 = CholeskySolver(solver.a, dataclasses.replace(
            solver.config, dense_top_cols=top), device=dev)
        ex2 = s2.executor
        lx2 = ex2.factorize_segmented(attribution.a_values(ex2, s2),
                                      group=_GROUP)
        out["top_s"] = solve_s(ex2, lx2, b)
        out["top_err"] = _checked(ex2, lx2, b, "dense-top solve")
        out["top_t"] = None if s2.plan.top is None else int(s2.plan.top.t)
        out["top_nseg"] = s2.plan.solve_nseg
    out["card"] = bench._card() if dev.type == "cuda" else "cpu"
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ks", type=str, default="")
    ap.add_argument("--top", type=int, default=0)
    ap.add_argument("--grid", type=int, default=48)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    _, solver, _ = bench.analyze(args.grid, dev)
    print(json.dumps(run(solver, dev,
                         ks=[int(k) for k in args.ks.split(",") if k],
                         top=args.top)))


if __name__ == "__main__":
    main()
