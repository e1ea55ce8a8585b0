#!/usr/bin/env python3
"""Rehearse ``chip_smoke.py`` on the CPU, before a call to the card:

    python tools/smoke_rehearsal.py

It runs chip_smoke.py's own ``main`` on small matrices, with every device
string turned to ``"cpu"`` and these stand-ins:

* the kernel wrappers of ``ops/kernels.py`` are their plain versions,
  counted as the wrappers count;
* ``graphs.Program.run`` acts out a capture: the first run calls the
  closure (the warm-up) and counts its launches once more (the capture's),
  later runs call it without counting (replays), so that the launch-count
  checks see what they see on the card;
* ``torch.cuda``'s queries, memory statistics, events and sleep, the card
  line (nvidia-smi), the kernel build, the probes' L2 flush and
  ``torch.profiler`` (whose CUDA activity on a CPU-only torch takes
  minutes and prints errors) answer with placeholders; the profiler
  stand-in counts the kernels each call runs, replays included;
* every device asked for resolves to the CPU;
* the plan-shape checks print instead of raising, and the kernel shapes
  of phases 3 and 7 are cut to the small plan's;
* the main path's matrix is laplace_3d(12) and phase 17's dense top
  takes at most 1,024 columns (a partial top there);
* the simplicial phase runs at laplace_3d(5) and the CLI (phase 15,
  real subprocesses, on the CPU) on small generated matrices;
* the bench (phase 18, a real subprocess) runs ``bench.run`` on the CPU
  at the main path's small matrix, its device key set to the card line's
  stand-in;
* the multi-device phase (16) runs its rank processes for real, gloo on
  the CPU, on the small plans; each rank installs the kernel stand-ins
  above before it runs (``_rank_with_stubs``), so that its K1 counts are
  what the card's would be;
* the reference-scale run (phase 20, a real subprocess) runs
  ``large_run`` on the CPU at laplace_3d(10) with ``REFERENCE_N`` at 500
  (the scatter mode and the pools' row sums) and this module's counted
  kernel stand-ins and acted-out capture, its device key set to the card
  line's stand-in; ``scale_test`` (a real subprocess) at laplace_3d(8);
* the sweep drivers (phase 21, real subprocesses) on the CPU: ``eval``
  at laplace_3d(6) (beside phase 16's ranks, as on the card),
  ``h1_vs_coarse`` at laplace_3d(8) with the counted
  kernel stand-ins and acted-out capture (its K1 counts are then what
  the card's would be) and ``calibrate_model`` at the main path's small
  matrix, their device keys set to the card line's stand-in;
* the attribution scripts (phase 19) run on the CPU at the main path's
  small matrix with 2 runs per sample; their profiles of whole calls
  (``scripts/attribution.device_ops``) count the kernel stand-ins' runs,
  as the profiler stand-in above does, while ``floor_r5``'s per-scope
  profile runs for real on the CPU (host time).

Every number it prints is a placeholder or a CPU time: it shows that the
script runs through, not how fast anything is.
"""
from __future__ import annotations

import functools
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.modules["jax"] = None

import torch  # noqa: E402

from parsy_bench_tpu_torch import CholeskySolver, SolverConfig, probes  # noqa
from parsy_bench_tpu_torch.core import generate  # noqa: E402
from parsy_bench_tpu_torch.ops import (build, dense, graphs,  # noqa: E402
                                       kernels, supernodal)
from parsy_bench_tpu_torch.parallel import comm  # noqa: E402
from parsy_bench_tpu_torch.scripts import attribution  # noqa: E402

#: kernel runs, replays included (what a profiler would see)
EXECUTED = {name: 0 for name in kernels._WRAPPERS}
REPLAYING = [False]


def _counted(name, plain):
    def wrapper(*args, **kw):
        EXECUTED[name] += 1
        if not REPLAYING[0]:
            wrapper.launches += 1
        return plain(*args, **kw)
    wrapper.launches = 0
    wrapper.__name__ = name
    setattr(kernels, name, wrapper)
    return wrapper


def _stub_kernels():
    k1 = _counted("cholesky_inverse_cuda", dense.cholesky_inverse)
    k2 = _counted("finalize_fused_cuda",
                  lambda blk, w, cnt, nchunk=None:
                  dense.finalize_fused(blk, w, cnt))
    _counted("probe_copy_cuda", probes.copy_plain)
    _counted("probe_matmul_cuda", probes.matmul_plain)
    _counted("gather_sum_cuda", probes.gather_sum_plain)
    supernodal.chol_inverse = k1
    supernodal.finalize_fused = k2
    build.build = lambda: "(kernels not built: CPU rehearsal)"
    build.build_log = lambda so: ""
    kernels._load = lambda: None


def _rank_with_stubs(fn, group, *args):
    """A rank of phase 16: the kernel stand-ins installed in this process
    too, then the rank's function (pickled by its path in this module)."""
    _stub_kernels()
    return fn(group, *args)


def _stub_launch():
    launch = comm.launch
    comm.launch = lambda fn, *a, **kw: launch(
        functools.partial(_rank_with_stubs, fn), *a, **kw)


def _program_run(self):
    if self.launches is None:
        before = kernels.launch_counts()
        self.fn()
        self.launches = graphs._delta(before)
        for name, n in self.launches.items():
            getattr(kernels, name).launches += n
        self.capture_s, self.nodes = 0.0, 0
    else:
        REPLAYING[0] = True
        try:
            self.fn()
        finally:
            REPLAYING[0] = False


class _Event:
    def __init__(self, *a, **kw):
        pass

    def record(self, *a):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 1.0


def _stub_cuda():
    c = torch.cuda
    c.is_available = lambda: True
    c.synchronize = lambda *a: None
    c.get_device_name = lambda *a: "CPU rehearsal"
    c.device_count = lambda: 1
    c.reset_peak_memory_stats = lambda *a: None
    c.max_memory_allocated = lambda *a: 0
    c.memory_allocated = lambda *a: 0
    c.memory_reserved = lambda *a: 0
    c.Event = _Event
    c._sleep = lambda *a: None
    graphs.Program.run = _program_run
    # entry points called without a device ask for the card
    from parsy_bench_tpu_torch.models import solver
    solver.resolve_device = supernodal.resolve_device = (
        lambda device: torch.device("cpu"))


def _cuda_ms(fn, reps, *a, **kw):
    fn()
    return 1.0


def _stub_probes():
    probes.cuda_ms = _cuda_ms
    probes.cuda_ms_cold = _cuda_ms
    probes.l2_flush = lambda device, how="read": (lambda: None)
    probes.ROWS, probes.HBM_ROWS, probes.NIDX = 1 << 12, 1 << 13, 1 << 10

    def run(device="cuda"):
        cpu = torch.device("cpu")
        return [probes._copy_record(cpu), probes._matmul_record(cpu),
                probes._gather_record(cpu, probes.ROWS, cold=False),
                probes._gather_record(cpu, probes.HBM_ROWS, cold=True)]
    probes.run = run


def _device_ops(torch, fn, kernel=(), top=0):
    fn()
    before = dict(EXECUTED)
    fn()
    ran = {k: EXECUTED[k] - before[k] for k in EXECUTED}
    n = (ran["cholesky_inverse_cuda"] if "chol_inverse_warp_kernel" in kernel
         else ran["finalize_fused_cuda"] if kernel else 0)
    return dict(ops=1, busy_ms=1.0, span_ms=1.0, wall_ms=2.0,
                idle_share_of_span=0.0, idle_share_of_wall=0.5,
                k_n=n, k_ms=1.0, by_name=[["(rehearsal)", 1, 1.0]][:top])


def _attr_device_ops(fn, device, kernel=(), expect=None):
    """``attribution.device_ops``: the stand-ins' runs in the second of
    two calls are its operations, K1's its ``k_n``."""
    fn()
    before = dict(EXECUTED)
    fn()
    ran = {k: EXECUTED[k] - before[k] for k in EXECUTED}
    out = dict(ops=sum(ran.values()), busy_ms=1.0, tries=1)
    if kernel:
        out.update(k_n=ran["cholesky_inverse_cuda"], k_ms=1.0)
    return out


#: the stand-ins whose runs a profile of phase 10 counts as device
#: operations (P3's ladder sums, P2's update products)
_PROFILED = ("gather_sum_cuda", "probe_matmul_cuda")


def _profiled_ms(torch, fn, flush, names=(), reps=10, skip=(), expect=1):
    fn()
    before = sum(EXECUTED[k] for k in _PROFILED)
    for _ in range(reps):
        flush()
        fn()
    return 1.0, (sum(EXECUTED[k] for k in _PROFILED) - before) / reps, 1.0


def main() -> int:
    _stub_kernels()
    _stub_cuda()
    _stub_probes()
    _stub_launch()
    attribution.device_ops = _attr_device_ops
    path = os.path.join(ROOT, "chip_smoke.py")
    with open(path) as f:
        src = f.read()
    for old, new in (('"cuda"', '"cpu"'),
                     ("laplace_3d(48)", "laplace_3d(12)"),
                     ("laplace_3d(24)", "laplace_3d(6)"),
                     ('raise AssertionError(f"plan\'s', 'print(f"plan\'s')):
        if old not in src:
            raise AssertionError(f"chip_smoke.py no longer holds {old!r}")
        src = src.replace(old, new)
    ns = {"__name__": "chip_smoke_rehearsal", "__file__": path}
    exec(compile(src, path, "exec"), ns)
    for name in ("SIMPLICIAL_GRID", "CLI_RUNS", "K1_SHAPES", "K1_SMALL",
                 "K2_SHAPES", "DIST_GROUPS", "SHARDED_G", "DIST_REPS",
                 "SIMPLICIAL_REPS", "SEGMENTED_GROUPS", "DENSE_TOP_COLS",
                 "GPOOL_MB", "BENCH_CMD", "ATTR_REPS", "SOLVE_KS",
                 "LARGE_CMD", "LARGE_GRID", "SCALE_CMD", "SCALE_ARGS",
                 "EVAL_CMD", "EVAL_ARGS", "H1_CMD", "H1_ARGS", "CAL_CMD",
                 "CAL_GRID", "_multi_device_phase", "_last_slice_phase",
                 "_attribution_phase", "_reference_scale_phase",
                 "_sweep_phase", "_scaling_rows", "_calibrate_line",
                 "_card", "_device_ops", "_profiled_ms"):
        if name not in ns:
            raise AssertionError(f"chip_smoke.py no longer defines {name}")
    card = "CPU rehearsal, no card"
    ns["_card"] = lambda: card
    ns["_device_ops"] = _device_ops
    ns["_profiled_ms"] = _profiled_ms
    # the kernel shapes of phases 3 and 7, cut to the small plan's
    s = CholeskySolver(generate.laplace_3d(12),
                       SolverConfig(ordering="nd", dtype="float32",
                                    tier="supernodal"), device="cpu")
    exf = supernodal.SupernodalExecutor(s.plan, "float32", "cpu",
                                        fused_finalize=True)
    fshapes = {(seg.fin[k].P, seg.fin[k].H, seg.fin[k].c)
               for seg, tabs in zip(s.plan.segments, exf._segs)
               for ks in tabs.fin_fused for k in ks}
    ns["K1_SHAPES"] = tuple(sorted(s.executor.chol_batch_shapes()))[:5]
    ns["K1_SMALL"] = ((3, 8), (3, 48))
    ns["K2_SHAPES"] = (max(fshapes), (4, 64, 32), (1, 96, 32), (3, 64, 64))
    # phase 17's dense top: a partial one at laplace_3d(12) (two of five
    # segments in the level steps)
    ns["DENSE_TOP_COLS"] = 1024
    # the simplicial phase and the CLI at small sizes
    ns["SIMPLICIAL_GRID"] = 5
    ns["CLI_RUNS"] = (("cholesky", "gen:laplace3d:5", "--verify",
                       "--profile"),
                      ("trisolve", "gen:laplace3d:5"),
                      ("trisolve", "gen:laplace3d:8", "--lower", "--tier",
                       "simplicial", "--schedule", "coarsened"))
    # the attribution scripts with 2 runs per sample
    ns["ATTR_REPS"] = 2
    # the bench on the CPU, at the main path's small matrix
    ns["BENCH_CMD"] = ("-c", "import json; from parsy_bench_tpu_torch "
                       "import bench; r = bench.run(grid=12, device='cpu'); "
                       f"r['device'] = {card!r}; print(json.dumps(r))")
    # the reference-scale run at laplace_3d(10) with its n threshold at
    # 500, so that it takes the scatter mode and the pools' row sums, with
    # the counted kernel stand-ins and the acted-out capture of this
    # module; scale_test at laplace_3d(8)
    ns["LARGE_GRID"] = 10
    ns["LARGE_CMD"] = (
        "-c", "import sys; sys.path.insert(0, 'tools'); "
        "import smoke_rehearsal as R; R._stub_kernels(); "
        "R.graphs.Program.run = R._program_run; "
        "from parsy_bench_tpu_torch.scripts import large_run as L; "
        "L.REFERENCE_N = 500; run = L.run; "
        f"L.run = lambda *a: dict(run(*a), device={card!r}); "
        "L.main(sys.argv[1:])")
    ns["SCALE_ARGS"] = ("8", "nd", "2")
    ns["SCALE_CMD"] = (
        "-c", "import json, sys; "
        "from parsy_bench_tpu_torch.scripts import scale_test as S; "
        f"S._line = lambda o: print(json.dumps(dict(o, device={card!r})), "
        "flush=True); S.main(sys.argv[1:])")
    # the sweep drivers on the CPU: eval at laplace_3d(6) (its nine lines),
    # h1_vs_coarse at laplace_3d(8), calibrate_model at the main path's
    # small matrix (phase 21 holds its segments to phase 4's plan); the
    # device key of h1_vs_coarse's rows and of the artifact set to the
    # card line's stand-in
    ns["EVAL_ARGS"] = ("gen:laplace3d:6", "--iters", "1", "--trisolve",
                       "--baselines")
    ns["H1_ARGS"] = ("8", "nd")
    ns["H1_CMD"] = (
        "-c", "import sys; sys.path.insert(0, 'tools'); "
        "import smoke_rehearsal as R; R._stub_kernels(); "
        "R.graphs.Program.run = R._program_run; "
        "from parsy_bench_tpu_torch.scripts import h1_vs_coarse as H; "
        f"row = H.row; H.row = lambda *a: dict(row(*a), device={card!r}); "
        "H.main(sys.argv[1:])")
    ns["CAL_GRID"] = 12
    ns["CAL_CMD"] = (
        "-c", "import sys; "
        "from parsy_bench_tpu_torch.scripts import calibrate_model as C; "
        f"run = C.run; C.run = lambda *a: dict(run(*a), device={card!r}); "
        "C.main(sys.argv[1:])")
    return ns["main"]()


if __name__ == "__main__":
    sys.exit(main())
