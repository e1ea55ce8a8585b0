"""Fit ``ChipModel``'s constants on the card from per-segment profiles of
the real plan, and check that the fitted model ranks the sweep variants as
the card does: the port's counterpart of ``scripts/calibrate_model.py``.

    python -m parsy_bench_tpu_torch.scripts.calibrate_model [grid]
        [out.json] [--device cuda]

``laplace_3d(grid)`` (48 by default, n = 110,592), ND, f32, supernodal
tier.  The fit is ``utils/calibrate``: ``collect`` (one row per segment,
its ``segment_features`` and its ``profile_segments`` time) and ``fit``
(non-negative least squares).  The fitted ``ChipModel`` is named after
the card (its name and power limit) and ``calibrate_model fit``.

The check (``validate``) takes the JAX script's three variants of the
default configuration (``VARIANTS``: ``segment_alpha=1.1``,
``q_classes=(48,136)``, ``slack_placement=True``) and prices each plan
with ``factorize_cost(plan, chip).model_s``, as JAX does.  The measured
side is the card's own, where the JAX script compares with GFLOP/s that a
TPU recorded: the default and each variant are factored in this process
and timed in interleaved turns (default, variant, variant, default, ...),
``PAIRS`` samples each, a sample being one synchronized ``factorize``
of the captured program on the host clock.  Each variant's factor is
gated: ``factor_ok()`` and max|1 - x| < 1e-3 of ``solve_spd`` with
b = A*1.  ``all_signs_correct`` holds where the model ranks each pair the
way the card measured it; disagreement is reported, not raised.

Writes the JAX artifact's keys (``ART_KEYS``) and the card (``device``)
to ``out.json`` (``calibration_torch.json`` by default) and prints it; a
failed gate exits with "verification failed" after the file is written.
Without CUDA the default device raises before anything is printed.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from parsy_bench_tpu_torch import bench
from parsy_bench_tpu_torch.models import CholeskySolver
from parsy_bench_tpu_torch.ops.device import resolve_device
from parsy_bench_tpu_torch.utils import calibrate
from parsy_bench_tpu_torch.utils.perfmodel import ChipModel, factorize_cost

DEFAULT_OUT = "calibration_torch.json"
PAIRS = 10
#: the JAX script's variants of the default configuration
VARIANTS = {
    "segment_alpha=1.1": dict(segment_alpha=1.1),
    "q_classes=(48,136)": dict(q_classes=(48, 136)),
    "slack_placement=on": dict(slack_placement=True),
}
#: the JAX artifact's keys, in its order, and the port's
ART_KEYS = ("grid", "n", "segments", "fitted", "validation", "wall_s")
EXTRA_KEYS = ("device",)
#: each variant's record: the JAX keys, then the card's measurement
SIGN_KEYS = ("model_s", "measured_gflops", "model_ranks_default_faster")
SIGN_EXTRA_KEYS = ("measured_ranks_default_faster", "pairs", "gates")


def chip_model(fitted: dict, card: str) -> ChipModel:
    """The ``ChipModel`` of a fit (JAX scripts/calibrate_model.py:289-299)
    named after the card."""
    return ChipModel(name=f"{card} calibrate_model fit",
                     **{c: fitted[c] for c in calibrate.COLUMNS})


def factorize_s(solver, data) -> float:
    """Host seconds of one synchronized ``factorize`` of ``solver``."""
    dev = solver.executor.device
    bench._sync(dev)
    t0 = time.perf_counter()
    solver.executor.factorize(data)
    bench._sync(dev)
    return time.perf_counter() - t0


def _stats(t):
    return dict(median=statistics.median(t), min=min(t), max=max(t),
                all=list(t))


def interleaved(a, b, pairs, sample):
    """Samples of ``a`` and ``b`` in turns (a, b, b, a, ...), ``pairs``
    each; their medians and spread, and in how many pairs a was faster."""
    ta, tb = [], []
    for k in range(pairs):
        order = ((a, ta), (b, tb)) if k % 2 == 0 else ((b, tb), (a, ta))
        for x, acc in order:
            acc.append(sample(x))
    return dict(default=_stats(ta), variant=_stats(tb),
                default_faster_in=sum(x < y for x, y in zip(ta, tb)),
                pairs=pairs)


def gates(solver) -> dict:
    """``factor_ok()`` of the solver's factor and max|1 - x| of
    ``solve_spd`` with b = A*1 (permuted), each with its bar."""
    ok = solver.factor_ok()
    b = np.asarray(solver.ap.spd_rhs_for_ones(), dtype=np.float32)
    x = solver.executor.solve_spd(solver.lx, b).cpu().numpy()
    err = float(np.max(np.abs(x - 1.0)))
    return dict(factor_ok=ok, solve_max_err=err,
                passed=bool(ok and err < 1e-3))


def validate(solver, chip, pairs=PAIRS, sample=None) -> dict:
    """The sign check of the module docstring on ``solver`` (the default
    configuration, on its device).  ``sample(solver, data)`` gives one
    timed factorize in seconds (``factorize_s`` by default)."""
    sample = sample or factorize_s
    dev = solver.executor.device
    t_base = factorize_cost(solver.plan, chip).model_s
    out = {"base_model_s": round(t_base, 4), "signs": {}}
    solver.factorize(check_spd=False)                # the capture
    base = (solver, torch.as_tensor(solver.ap.data.astype(np.float32),
                                    device=dev))
    for name, kw in VARIANTS.items():
        sv = CholeskySolver(solver.a, solver.config.replace(**kw),
                            device=dev)
        tv = factorize_cost(sv.plan, chip).model_s
        sv.factorize(check_spd=False)                # the capture
        g = gates(sv)
        var = (sv, torch.as_tensor(sv.ap.data.astype(np.float32),
                                   device=dev))
        p = interleaved(base, var, pairs, lambda x: sample(*x))
        measured = p["default"]["median"] < p["variant"]["median"]
        out["signs"][name] = {
            "model_s": round(tv, 4),
            "measured_gflops": sv.plan.flops / p["variant"]["median"] / 1e9,
            "model_ranks_default_faster": bool(tv > t_base),
            "measured_ranks_default_faster": bool(measured),
            "pairs": dict(p, default_gflops=solver.plan.flops
                          / p["default"]["median"] / 1e9),
            "gates": g,
        }
        del sv, var
    out["all_signs_correct"] = all(
        v["model_ranks_default_faster"] == v["measured_ranks_default_faster"]
        for v in out["signs"].values())
    return out


def run(grid: int = 48, device="cuda", pairs=PAIRS, sample=None) -> dict:
    """The artifact (``ART_KEYS`` then ``EXTRA_KEYS``) at
    ``laplace_3d(grid)`` on ``device``."""
    dev = resolve_device(device)
    bench.build_kernels(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = bench._card() if dev.type == "cuda" else "cpu"
    t0 = time.time()
    _, s, _ = bench.analyze(grid, dev)
    rows = calibrate.collect(s)
    fitted = calibrate.fit(rows)
    val = validate(s, chip_model(fitted, card), pairs, sample)
    return {"grid": grid, "n": int(s.a.n), "segments": len(rows),
            "fitted": {k: (None if np.isinf(v) else float(v))
                       for k, v in fitted.items()},
            "validation": val,
            "wall_s": round(time.time() - t0, 1),
            "device": card}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("grid", nargs="?", type=int, default=48)
    ap.add_argument("out", nargs="?", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    art = run(args.grid, args.device)
    with open(args.out, "w") as f:
        json.dump(art, f, indent=1)
    print(json.dumps(art, indent=1))
    if not all(v["gates"]["passed"]
               for v in art["validation"]["signs"].values()):
        raise SystemExit("verification failed")


if __name__ == "__main__":
    main()
