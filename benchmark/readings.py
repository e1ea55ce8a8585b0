"""The readings a cell's output limit is set from, in one process on the
card (set-up is paid once: the analysis depends on the pattern only).

    python3 benchmark/readings.py --workload <name> [--seeds 12]
        [--seconds 5] [--control-seeds 3] [--first-seed 2147483648]

* lower: the program, as the timed path runs it (``ProgramSystem``, the
  mix's steps, closed loop for ``--seconds``), on ``--seeds`` seeds, each
  with its own inputs; ``x_err`` of each (the step kind's ``check``);
* upper: the control, the plain reference in TF32 put in the program's
  place (``harness.ReferenceSystem``), for as many steps as the mix
  samples, on ``--control-seeds`` seeds.

Prints a JSON line per seed and one summary line.  The benchmark's own runs
do not run this.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or os.curdir) != HERE]


def _readings(cell, system, seeds, seconds, dev, control):
    from benchmark import harness
    kind, mix = cell.steps, cell.mix
    out = []
    for seed in seeds:
        inputs = kind.make_inputs(cell, seed)
        sysm = (kind.make_system(harness.ReferenceSystem, inputs, cell, dev)
                if control else system)
        feed = kind.prepare(sysm, inputs, mix)
        kind.window(sysm, feed, mix, None, seed, steps=1)
        if control:
            win = kind.window(sysm, feed, mix, None, seed,
                              steps=mix["sample"])
        else:
            win = kind.window(sysm, feed, mix, seconds, seed)
        del sysm, feed
        checks = kind.check(inputs, win.sample, dev, cell.limits, win.failed)
        row = {"seed": seed, "control": control, "steps": win.attempted,
               "failed": win.failed, "sampled": len(win.sample.kept),
               "x_err": checks["x_err"]["value"]}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=2**31)
    args = p.parse_args(argv)
    import torch

    from benchmark import harness
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    cell = harness.find_cell(
        harness.load_json(os.path.join(ROOT, "BENCHMARK.json")),
        args.workload)
    seeds = [args.first_seed + i for i in range(args.seeds)]
    t0 = time.perf_counter()
    system = cell.steps.make_system(
        harness.ProgramSystem, cell.steps.make_inputs(cell, seeds[0]), cell,
        dev)
    lower = _readings(cell, system, seeds, args.seconds, dev, False)
    del system
    upper = _readings(cell, None, seeds[:args.control_seeds], None, dev,
                      True)
    lo = max(r["x_err"] for r in lower)
    up = min(r["x_err"] for r in upper)
    print(json.dumps({"workload": cell.name, "lower": lo, "upper": up,
                      "ratio": up / lo, "seconds": time.perf_counter() - t0,
                      "card": harness.card_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
