"""The benchmark's harness: one cell of ``BENCHMARK.json``, run once.

Everything is found by name, so that a later change adds a cell by adding
files and entries, and edits none:

* the cell (``workloads``) names its configuration and its traffic mix;
* a configuration is ``configs/<config>.json``: the matrix (``matrix``:
  its ``kind``, the module ``benchmark/<kind>.py`` that makes it, and its
  sizes) and the ``SolverConfig`` fields it sets (``solver``);
* a traffic mix is ``traffic/<mix>.json``, data read by the step kind its
  ``step`` key names, ``steps/<kind>.py`` (``steps/__init__.py`` says what
  a kind provides): the pools the seed makes, how many answers the check
  samples, how many steps the traced run profiles, and which statistic of
  the step times each end-to-end metric is;
* a per-layer metric is ``metrics/<metric>.py``, a reader of a ``Run``
  (its unit, layer and the metric it moves are in ``BENCHMARK.json``);
* the limit of each number the check compares is in
  ``limits/<workload>.json``.

The system under test is ``parsy_bench_tpu_torch``'s ``CholeskySolver``,
driven through its public ``factorize(A)`` and ``solve(b)`` with host
arrays, as a user calls it (``ProgramSystem``).  The step kind's check holds
the sampled answers against the plain reference (``reference.py``) once the
window has closed, the peak memory has been read and the program's state is
freed.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from benchmark import devtrace, reference

HERE = os.path.dirname(os.path.abspath(__file__))
#: the modules no run may hold once its window has closed, by top-level
#: name compared whole (``parsy_bench_tpu_torch`` is the port, not these)
FORBIDDEN = ("jax", "jaxlib", "flax", "parsy_bench_tpu")


# ------------------------------------------------------------- finding
def load_json(path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with everything it names."""
    name: str
    chips: int
    config: dict         # configs/<config>.json
    mix: dict            # traffic/<mix>.json
    steps: object        # steps/<kind>.py, the kind the mix names
    limits: dict         # limits/<workload>.json
    end_to_end: list     # the BENCHMARK.json entries this cell reports
    per_layer: list


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(bench: dict, workload: str, here: str = HERE) -> Cell:
    """The cell ``workload`` of the parsed ``BENCHMARK.json``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(it has {sorted(cells)})")
    w = cells[workload]
    e2e = [m for m in bench["end_to_end"] if reports(m, workload)]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (workload in m["workloads"] if "workloads" in m
               else m["moves"] in names)]
    mix = load_json(os.path.join(here, "traffic", w["traffic"] + ".json"))
    steps = importlib.import_module("benchmark.steps." + mix["step"])
    return Cell(workload, int(w["chips"]),
                load_json(os.path.join(here, "configs",
                                       w["config"] + ".json")),
                mix, steps,
                load_json(os.path.join(here, "limits", workload + ".json")),
                e2e, per)


def load_metric(name: str, here: str = HERE):
    """The reader module ``metrics/<name>.py`` (names may hold dots)."""
    path = os.path.join(here, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -------------------------------------------------------------- systems
class ProgramSystem:
    """``parsy_bench_tpu_torch``'s ``CholeskySolver`` on one pattern, with
    the configuration's ``SolverConfig`` fields and every other knob at the
    program's default.  ``factorize`` and ``solve`` are the solver's own
    bound methods."""

    def __init__(self, pat, data0, solver_fields: dict, device):
        from parsy_bench_tpu_torch.config import SolverConfig
        from parsy_bench_tpu_torch.core.csc import CSC
        from parsy_bench_tpu_torch.models import CholeskySolver
        self._csc, self._pat = CSC, pat
        self.solver = CholeskySolver(self.matrix(data0),
                                     SolverConfig(**solver_fields),
                                     device=device)
        self.factorize = self.solver.factorize
        self.solve = self.solver.solve

    def matrix(self, data):
        p = self._pat
        return self._csc(p.n, p.indptr, p.indices, data)


class ReferenceSystem:
    """The plain reference put in the program's place, at ``precision``:
    the control of the check (``reference.BandedCholesky``)."""

    def __init__(self, pat, data0, solver_fields: dict, device,
                 precision="tf32"):
        self._pat, self.device, self.precision = pat, device, precision
        self._fac = None

    def matrix(self, data):
        return data

    def factorize(self, data):
        self._fac = None
        p = self._pat
        self._fac = reference.BandedCholesky(p.indptr, p.indices, data,
                                             self.device, self.precision)

    def solve(self, b):
        return self._fac.solve(b).astype(np.float32)


# --------------------------------------------------------------- window
class Sample:
    """A uniform sample of ``size`` steps' answers, drawn from the seed
    (reservoir sampling): step k's answer is kept with probability
    size / (k + 1), in place of a kept one drawn at random."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng([seed, 1])
        self.kept = []      # (step, value set, rhs, x)
        self.seen = 0

    def offer(self, item):
        k = self.seen
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append(item)
            return
        j = int(self.rng.integers(0, k + 1))
        if j < self.size:
            self.kept[j] = item


@dataclasses.dataclass
class Window:
    times: list          # seconds of each step that completed
    wall: float          # seconds from the window's start to its last end
    attempted: int
    failed: int
    errors: list
    sample: Sample


def step_stats(times, wall) -> dict:
    """The statistics an end-to-end metric may name: ``mean_ms`` (the
    window's wall time over the steps completed) and ``p95_ms`` (the 95th
    percentile of all steps' times)."""
    if not times:
        return {}
    out = {"mean_ms": wall / len(times) * 1e3}
    if len(times) >= 2:
        out["p95_ms"] = statistics.quantiles(
            times, n=100, method="inclusive")[94] * 1e3
    return out


def spread_ms(times) -> dict:
    """How the steps' times spread, for the set-up line: quartiles, the
    extremes, the first steps and the mean of each half of the window."""
    if len(times) < 4:
        return {}
    ms = [t * 1e3 for t in times]
    h = len(ms) // 2
    return {"min": min(ms), "quartiles": statistics.quantiles(ms, n=4),
            "max": max(ms), "first": ms[:4],
            "halves": [statistics.fmean(ms[:h]), statistics.fmean(ms[h:])]}


# ---------------------------------------------------------------- check
def passes(checks: dict) -> bool:
    """Every number within its limit (NaN is not)."""
    return all(c["value"] <= c["limit"] for c in checks.values())


# ------------------------------------------------------------------ run
@dataclasses.dataclass
class Run:
    """What a per-layer metric's reader reads."""
    cell: Cell
    #: host-clock spans of set-up, seconds: ``analyze``, ``capture``
    spans: dict
    #: the traced window (None on a run without ``--trace 1``)
    trace: object
    #: seconds the traced steps took when run without the profiler, just
    #: before it (None on a run without ``--trace 1``)
    untraced_s: object
    system: object
    device_kind: str


def forbidden_modules() -> list:
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        f"nvidia-smi: {out.stderr.strip()}")


def log(obj) -> None:
    print(json.dumps(obj), file=sys.stderr, flush=True)


def stop_if_forbidden() -> None:
    bad = forbidden_modules()
    if bad:
        raise ForbiddenModules(bad)


def run(cell: Cell, seed: int, seconds: float, traced: bool, device,
        t_process: float, make_system=ProgramSystem) -> dict:
    """One run of ``cell``: set-up, the window (or the traced window), the
    check; returns the result line's object.  ``t_process`` is the
    ``time.perf_counter()`` the process started its clock at.  It raises
    ``ForbiddenModules`` where a module of JAX or of the JAX package is
    loaded once the window has closed, and again after the last of its
    work (the metrics' readers and the check)."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    kind, mix = cell.steps, cell.mix
    setup = {"import_s": time.perf_counter() - t_process}

    t0 = time.perf_counter()
    inputs = kind.make_inputs(cell, seed)
    setup["inputs_s"] = time.perf_counter() - t0

    spans = {}
    t0 = time.perf_counter()
    system = kind.make_system(make_system, inputs, cell, dev)
    spans["analyze"] = time.perf_counter() - t0
    solver = getattr(system, "solver", None)
    setup["analyze_s"] = spans["analyze"]
    setup["analyze_stages"] = dict(getattr(solver, "timings", {}))

    t0 = time.perf_counter()
    feed = kind.prepare(system, inputs, mix)
    setup["matrices_s"] = time.perf_counter() - t0

    # the first step captures the programs; the second replays them
    t0 = time.perf_counter()
    warm = kind.window(system, feed, mix, None, seed, steps=1)
    spans["capture"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    warm2 = kind.window(system, feed, mix, None, seed, first_step=1, steps=1)
    setup["capture_s"], setup["replay_s"] = (spans["capture"],
                                             time.perf_counter() - t0)
    if warm.failed or warm2.failed:
        log({"warm_up_errors": warm.errors + warm2.errors})
    gc.collect()
    if cuda:
        torch.cuda.synchronize(dev)
    t_window = time.perf_counter()
    setup_s = t_window - t_process
    log({"setup": dict(setup, setup_s=setup_s)})

    tr = untraced_s = None
    if traced:
        # the same steps untraced first: the wall time the idle share is
        # taken over, without what the profiler adds to a step
        untraced_s = kind.window(system, feed, mix, None, seed,
                                 first_step=2).wall
        box = {}

        def traced_steps():
            box["w"] = kind.window(system, feed, mix, None, seed,
                                   first_step=2, spans=True)
        t0 = time.perf_counter()
        tr = devtrace.profile(traced_steps, dev)
        win = box["w"]
        log({"trace_cost": {
            "steps": win.attempted,
            "untraced_ms_per_step": untraced_s / win.attempted * 1e3,
            "traced_ms_per_step": win.wall / win.attempted * 1e3,
            "profile_s": time.perf_counter() - t0}})
    else:
        win = kind.window(system, feed, mix, seconds, seed)

    stop_if_forbidden()
    if win.errors:
        log({"step_errors": win.errors[:5]})

    kind_name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    dinfo = {"platform": "gpu" if cuda else "cpu", "kind": kind_name,
             "count": cell.chips if cuda else 0,
             "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                   if cuda else 0)}
    metrics, breakdown = {}, None
    if traced:
        ctx = Run(cell, spans, tr, untraced_s, system, kind_name)
        for m in cell.per_layer:
            value = load_metric(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if cuda:
            dinfo["busy_s"] = tr.busy_s()
            dinfo["window_s"] = tr.window_s()
            breakdown = {"device_ops": devtrace.top_ops(tr),
                         "idle_gaps": devtrace.top_gaps(tr)}
    else:
        stats = step_stats(win.times, win.wall)
        stats["setup_s"] = setup_s
        for m in cell.end_to_end:
            stat = "setup_s" if m["name"] == "setup_s" else \
                mix["metrics"].get(m["name"])
            if stat in stats:
                metrics[m["name"]] = {"value": stats[stat], "unit": m["unit"]}
    log({"window": {"steps": win.attempted, "failed": win.failed,
                    "wall_s": win.wall, "sampled": len(win.sample.kept),
                    "step_ms": spread_ms(win.times)},
         "card": card_line() if cuda else "cpu",
         "memory_peak_bytes": dinfo["memory_peak_bytes"]})

    # the program's state goes before the reference runs
    del system, solver, feed, tr, warm, warm2
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks = kind.check(inputs, win.sample, dev, cell.limits, win.failed)
    log({"reference_s": time.perf_counter() - t0})
    stop_if_forbidden()
    out = {"correct": passes(checks) and bool(win.sample.kept),
           "attempted": win.attempted, "failed": win.failed,
           "metrics": metrics, "device": dinfo}
    if breakdown is not None:
        out["breakdown"] = breakdown
    # a number that is not finite (no answer, or NaN in one) stays
    # readable JSON
    out["checks"] = {k: {"value": float(c["value"]) if np.isfinite(
        c["value"]) else str(float(c["value"])), "limit": c["limit"]}
        for k, c in checks.items()}
    return out


class ForbiddenModules(RuntimeError):
    """A run's process holds a module of JAX or of the JAX package."""

    def __init__(self, names):
        super().__init__("modules of JAX or the JAX package are loaded: "
                         + ", ".join(names))
        self.names = names
