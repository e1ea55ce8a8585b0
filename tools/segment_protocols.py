#!/usr/bin/env python3
"""Each segment of the main path's plan timed under three protocols, on
the card:

    python3 tools/segment_protocols.py [grid]

``laplace_3d(grid)`` (48 by default, n = 110,592), ND, f32, supernodal,
on executors of its own:

* ``jax_1``, ``jax_2``: the JAX executor's ``profile_segments`` protocol
  (the port's until it took ``SegmentTimer``'s): the pools restored to
  the segment's input, one warm run, then ``iters`` samples of ``reps``
  runs back to back, each on the previous run's output, between two CUDA
  events recorded as the host enqueues them; twice, one pass after the
  other;
* ``own`` and ``restored``: ``ops/supernodal.SegmentTimer``'s turns
  (a device sleep before each sample, so that the host enqueues the runs
  first) of two programs of the segment's steps: ``own`` runs them on its
  own output, as JAX does (its restore-only time added back, since the
  timer subtracts it from every program), ``restored`` first restores the
  rows the steps write, its restore-only time subtracted: the port's
  ``profile_segments``.

After their runs on their own output the pools hold NaN
(``attribution.reps_on_own_output``).  Prints the card line, one line per
comparison (``chip_smoke._segment_times``: the ratio of the sums, the
largest and smallest ratio of a segment, the ranking, agreement within
``chip_smoke.SEGMENT_TIME_TOL``) and the per-segment seconds of every
protocol.  Needs a CUDA card.
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.modules["jax"] = None

import chip_smoke  # noqa: E402

ITERS = 3
REPS = 20


def jax_protocol(ex, a, graphs):
    """Per segment, seconds per run: the JAX ``profile_segments``
    protocol on the static pools of ``ex``."""
    ex._load_a(a)
    ex._program("init", ex._chain(0, 0, init=True)).run()
    state = [p.clone() for p in ex._pools]

    def restore():
        for p, s in zip(ex._pools, state):
            p.copy_(s)
    out = []
    for lo, hi in ex.group_bounds(1):
        prog = ex._program(f"jax:segment[{lo}]", ex._chain(lo, hi))

        def run_reps():
            for _ in range(REPS):
                prog.run()
        restore()
        prog.run()
        times = []
        for _ in range(ITERS):
            restore()
            times.append(graphs.elapsed_s(ex.device, run_reps))
        restore()
        prog.run()
        for s, p in zip(state, ex._pools):
            s.copy_(p)
        out.append(sorted(times)[len(times) // 2] / REPS)
    return out


def timer_protocols(ex, a, supernodal, floor_r5):
    """Per segment, (own, restored) seconds per run in
    ``SegmentTimer``'s turns."""
    timer = supernodal.SegmentTimer(ex, a, "protocols", ITERS, REPS)
    own, restored = [], []
    for i in range(len(ex.plan.segments)):
        timer.begin(i)
        body = floor_r5.segment_body(ex, i, "full")
        real = timer.program("restored", body)
        mine = ex._program(f"protocols:own[{i}]", body)
        t, restore_s = timer.time({"restored": real, "own": mine})
        own.append(t["own"] + restore_s)
        restored.append(t["restored"])
        real.run()      # the pools then hold the next segment's input
    return own, restored


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("segment_protocols: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from parsy_bench_tpu_torch import bench
    from parsy_bench_tpu_torch.ops import graphs, supernodal
    from parsy_bench_tpu_torch.scripts import attribution, floor_r5
    card = chip_smoke._card()
    print(card)
    grid = int(sys.argv[1]) if len(sys.argv) > 1 else 48
    dev = torch.device("cuda", torch.cuda.current_device())
    bench.build_kernels(dev)
    _, solver, _ = bench.analyze(grid, dev)
    ex = attribution.own_executor(solver, dev)
    a = attribution.a_values(ex, solver)
    t = {"jax_1": jax_protocol(ex, a, graphs),
         "jax_2": jax_protocol(ex, a, graphs)}
    del ex
    ex = attribution.own_executor(solver, dev)
    t["own"], t["restored"] = timer_protocols(ex, a, supernodal, floor_r5)
    for x, y in (("jax_1", "jax_2"), ("own", "restored"),
                 ("jax_1", "restored"), ("jax_2", "restored")):
        c = chip_smoke._segment_times(t[x], t[y])
        print(f"{x} / {y}", json.dumps(
            {k: c[k] for k in ("sum_ratio", "max_ratio", "min_ratio",
                               "worst_segment", "same_ranking",
                               "within_tol", "tol")}))
    print(json.dumps(dict(grid=grid, n=int(solver.a.n), iters=ITERS,
                          reps=REPS, seconds=t, card=card)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
