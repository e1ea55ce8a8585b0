"""Run one cell of ``BENCHMARK.json`` once, on one NVIDIA card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  It makes the cell's inputs from the seed,
sets up (analyze, capture, warm-up), runs the window for ``--seconds``
(``--trace 1``: profiles the mix's ``trace_steps`` steps instead), checks
the answers against the plain reference, and prints one JSON line as the
last line of its standard output: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number compared beside its limit.  The checks are also the
last lines of its standard error.  It exits non-zero and prints no line
where CUDA is missing or has fewer cards than the cell asks for, or where a
module of JAX or of the JAX package is loaded once the window has closed
(looked for after the window and again after the metrics and the check).
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _checkout_env() -> None:
    """The build and kernel caches of every library that keeps one, at
    fixed paths inside the checkout (the program's own builds land in its
    ``_build`` directories, also inside the checkout); the checkout's root
    in place of this script's directory on the path, whose module names
    would shadow others."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(HERE, "_cache", sub)
    sys.path[:] = [ROOT] + [p for p in sys.path
                          if os.path.abspath(p or os.curdir) != HERE]


def _cuda_cards() -> int:
    import torch
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark import harness
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = harness.find_cell(bench, args.workload)
    cards = _cuda_cards()
    if not cards:
        print("CUDA is not available: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if cards < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, this machine has "
              f"{cards}", file=sys.stderr)
        return 2
    try:
        out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda:0", T_PROCESS)
    except harness.ForbiddenModules as e:
        print(str(e), file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    _checkout_env()
    sys.exit(main())
