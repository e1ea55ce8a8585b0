"""Parameter-sweep evaluation: the port's counterpart of
``scripts/eval.py`` (the reference's scripts/eval.sh + lib_eval.sh).

    python -m parsy_bench_tpu_torch.scripts.eval gen:laplace3d:16 \\
        [more matrices] [--iters 5] [--baselines] [--trisolve] [--device cuda]

The JAX script's sweep, arguments and protocol: for each matrix, one
``cholesky --verify`` run per tier x ordering x supernode width cap
(``SWEEP``), with the cap swept on the supernodal tier only and no
simplicial run on a ``randspd`` matrix; with ``--trisolve`` a ``trisolve``
run per tier; with ``--baselines`` the scipy ``baseline`` run.  Each run is
a subprocess of the port's driver, ``python -m parsy_bench_tpu_torch.cli``,
with ``PYTHONPATH`` set to the checkout's root, so the port is found from
any directory.  Its JSON lines pass through unchanged; a run that exits
non-zero adds ``{"error": <its arguments>, "stderr": <its last 400
characters>}``.

``--device`` (default ``cuda``) goes to every ``cholesky`` and ``trisolve``
run (``baseline`` runs scipy on the host and takes none).  The device is
resolved before the first run: without CUDA the default raises, and no
line is printed.  A Cholesky line's ``compile_s`` holds the capture of the
executor's program, and also the kernels' nvcc build when no earlier
process of the checkout has built them.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys

from parsy_bench_tpu_torch.ops.device import resolve_device

SWEEP = {
    "tier": ["simplicial", "supernodal"],
    "ordering": ["amd", "nd"],
    "max_width": [64, 128],
}
#: the checkout's root, the subprocesses' ``PYTHONPATH``
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: the driver's subcommands that run on a device
DEVICE_CMDS = ("cholesky", "trisolve")


def run(cmd: list[str], device: str = "cuda") -> None:
    """One run of the port's driver with the JAX script's arguments
    ``cmd`` (and ``--device`` where the subcommand takes one); prints its
    JSON lines, and the error line where it exits non-zero."""
    argv = list(cmd) + (["--device", device] if cmd[0] in DEVICE_CMDS
                        else [])
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-m", "parsy_bench_tpu_torch.cli"]
                       + argv, capture_output=True, text=True, env=env)
    for line in r.stdout.splitlines():
        if line.startswith("{"):
            print(line, flush=True)
    if r.returncode != 0:
        print(json.dumps({"error": cmd, "stderr": r.stderr[-400:]}),
              flush=True)


def commands(matrices, iters, baselines=False, trisolve=False):
    """The driver's argument lists of the sweep, in the JAX script's
    order."""
    out = []
    for mtx in matrices:
        for tier, ordering, w in itertools.product(
                SWEEP["tier"], SWEEP["ordering"], SWEEP["max_width"]):
            if tier == "simplicial" and w != SWEEP["max_width"][-1]:
                continue  # width cap only affects the supernodal tier
            if tier == "simplicial" and "randspd" in mtx:
                # near-dense factors: the scalar level-scheduled tier's
                # per-element plan explodes (JAX scripts/eval.py:51-58);
                # the supernodal tier covers the class
                continue
            out.append(["cholesky", mtx, "--tier", tier, "--ordering",
                        ordering, "--max-width", str(w),
                        "--iters", str(iters), "--verify"])
        if trisolve:
            for tier in SWEEP["tier"]:
                out.append(["trisolve", mtx, "--tier", tier,
                            "--iters", str(iters)])
        if baselines:
            out.append(["baseline", mtx, "--iters", str(iters)])
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("matrices", nargs="+")
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--baselines", action="store_true",
                   help="also run the scipy library baselines (lib_eval.sh)")
    p.add_argument("--trisolve", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="device of the cholesky and trisolve runs: cuda "
                        "(default), cuda:<i> or cpu")
    args = p.parse_args(argv)
    resolve_device(args.device)
    for cmd in commands(args.matrices, args.iters, args.baselines,
                        args.trisolve):
        run(cmd, args.device)


if __name__ == "__main__":
    main()
