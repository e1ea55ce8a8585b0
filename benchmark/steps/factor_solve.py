"""The step kind ``factor_solve``: each step factorizes new values (when the
mix's ``refactor`` is true) and solves one right-hand side; without
``refactor`` the first step factorizes once and every step solves against
that factor.

The mix's keys it reads: ``refactor`` (true or false), ``value_sets`` and
``rhs`` (the pools the seed makes, cycled by the steps), ``sample`` (the
answers the check compares), ``trace_steps`` (the steps of a traced run).
"""
from __future__ import annotations

import dataclasses
import importlib
import time

import numpy as np

from benchmark import devtrace, harness, reference


@dataclasses.dataclass
class Inputs:
    """What the seed makes: the pattern, the value sets, the right-hand
    sides."""
    pattern: object
    values: list
    rhs: list


@dataclasses.dataclass
class Feed:
    """The value sets as the system takes them, the right-hand sides, and
    the value set of the factor the system holds (None: none yet)."""
    mats: list
    rhs: list
    held: object = None


def make_inputs(cell, seed: int) -> Inputs:
    """The mix's value sets and right-hand sides from ``seed``: the same
    seed gives the same inputs, and every seed the same sizes."""
    rng = np.random.default_rng(seed)
    kind = importlib.import_module(
        "benchmark." + cell.config["matrix"]["kind"])
    pat, vals = kind.build(cell.config["matrix"], rng,
                           cell.mix["value_sets"])
    rhs = [rng.standard_normal(pat.n) for _ in range(cell.mix["rhs"])]
    return Inputs(pat, vals, rhs)


def make_system(factory, inputs: Inputs, cell, device):
    """The system on the inputs' pattern (the analysis)."""
    return factory(inputs.pattern, inputs.values[0], cell.config["solver"],
                   device)


def prepare(system, inputs: Inputs, mix) -> Feed:
    return Feed([system.matrix(v) for v in inputs.values], inputs.rhs)


def step_plan(mix, k, nv, nr):
    """(value set to factorize before step k or None, rhs of step k)."""
    return (k % nv if mix["refactor"] else None), k % nr


def window(system, feed: Feed, mix, seconds, seed, first_step=0,
           spans=False, steps=None) -> harness.Window:
    """Steps of the mix back to back, one caller (closed loop), until
    ``seconds`` have passed; each step's answer is offered to the sample.
    ``seconds`` = None runs ``steps`` steps (the mix's ``trace_steps`` by
    default); ``spans`` puts each step in the harness's spans
    (``devtrace.span``): the traced window."""
    fact, solve = system.factorize, system.solve
    mats, rhs = feed.mats, feed.rhs
    if steps is None:
        steps = mix["trace_steps"]
    if not mix["refactor"] and feed.held is None:
        fact(mats[0])
        feed.held = 0
    sample = harness.Sample(mix["sample"], seed)
    times, errors, failed = [], [], 0
    k = first_step
    t_start = now = time.perf_counter()
    while (now - t_start < seconds if seconds is not None
           else k - first_step < steps):
        v, r = step_plan(mix, k, len(mats), len(rhs))
        t0 = now
        try:
            if spans:
                with devtrace.span("step"):
                    if v is not None:
                        with devtrace.span("factorize"):
                            fact(mats[v])
                    with devtrace.span("solve"):
                        x = solve(rhs[r])
            else:
                if v is not None:
                    fact(mats[v])
                x = solve(rhs[r])
        except Exception as e:  # noqa: BLE001 - a failed step is counted
            failed += 1
            errors.append(f"step {k}: {type(e).__name__}: {e}")
            if v is not None:
                feed.held = None
            now = time.perf_counter()
            k += 1
            continue
        now = time.perf_counter()
        if v is not None:
            feed.held = v
        times.append(now - t0)
        sample.offer((k, feed.held, r, x))
        k += 1
    return harness.Window(times, now - t_start, k - first_step, failed,
                          errors, sample)


def check(inputs: Inputs, sample, device, limits: dict, failed: int) -> dict:
    """Each number compared, beside its limit: ``x_err``, the largest over
    the sampled answers of max|x - x_ref| / max|x_ref|, x_ref from the
    float64 reference; ``failed``, the steps that raised."""
    pat = inputs.pattern
    worst = 0.0 if sample.kept else float("nan")
    by_set = {}
    for k, v, r, x in sample.kept:
        by_set.setdefault(v, []).append((r, x))
    for v, items in sorted(by_set.items(), key=lambda kv: str(kv[0])):
        if v is None:           # no factor held: never correct
            worst = float("inf")
            continue
        ref = reference.BandedCholesky(pat.indptr, pat.indices,
                                       inputs.values[v], device, "float64")
        rs = sorted({r for r, _ in items})
        xr = ref.solve(np.stack([inputs.rhs[r] for r in rs], axis=1))
        col = {r: i for i, r in enumerate(rs)}
        del ref
        for r, x in items:
            want = xr[:, col[r]]
            err = (np.max(np.abs(np.asarray(x, np.float64) - want))
                   / np.max(np.abs(want)))
            worst = max(worst, err) if err == err else float("nan")
    return {"x_err": {"value": worst, "limit": limits["x_err"]["limit"]},
            "failed": {"value": failed, "limit": 0}}
