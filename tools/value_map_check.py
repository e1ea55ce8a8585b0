#!/usr/bin/env python3
"""The value map of ``CholeskySolver.factorize(a)`` on the card: is the
factor bit for bit the one the host permutation gives, and what does each
way of moving ``a.data`` into the factor's order cost?

    python3 tools/value_map_check.py [--dims 48,48,48 --dims 1000,1000]

For each grid (the benchmark's own generator, ``benchmark/grid.py``, with
the coefficients of its grid configurations; ND, f32, supernodal) it
analyses one value set, factorizes two more (capture, replay), and holds
three factorizes against ``executor.factorize`` fed the host permutation
``a.permute(perm).data``.  Then it times, with a synchronize around each
sample (median, min, max in ms):

* ``host_permute_ms``: the host permutation the value map replaced;
* ``cast_then_upload_gather_ms``, ``upload_then_cast_gather_ms``,
  ``upload_gather_then_cast_ms``: where the cast to the executor's dtype
  goes beside the copy to the card and the gather (the solver casts
  first);
* ``gather_values_ms``: the solver's check, copy and gather for the very
  analysed arrays, and ``pattern_check_copy_ms`` for equal copies of them;
* ``factorize_new_ms`` and ``factorize_old_ms``: a whole factorize with
  the SPD check, by the map and by the host permutation.

Prints the card line and one JSON line per grid.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import grid  # noqa: E402
from parsy_bench_tpu_torch.config import SolverConfig  # noqa: E402
from parsy_bench_tpu_torch.core.csc import CSC  # noqa: E402
from parsy_bench_tpu_torch.models import CholeskySolver  # noqa: E402


def _ms(fn, reps):
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return [statistics.median(ts), min(ts), max(ts)]


def check(dims, seed):
    pat, vals = grid.build({"dims": dims, "shift": 0.05,
                            "coefficients": [0.5, 1.5]},
                           np.random.default_rng(seed), 3)

    def mk(v):
        return CSC(pat.n, pat.indptr, pat.indices, v)

    t0 = time.perf_counter()
    s = CholeskySolver(mk(vals[0]), SolverConfig(
        ordering="nd", dtype="float32", tier="supernodal"))
    analyze_s = time.perf_counter() - t0
    a1, a2 = mk(vals[1]), mk(vals[2])
    s.factorize(a1)
    s.factorize(a2)
    same = True
    for a in (a1, a2, a1):
        got = s.factorize(a).lx
        want = s.executor.factorize(a.permute(s.perm).data)
        same &= all(torch.equal(x, y) for x, y in zip(got, want))
    dev, dt, vm = s.device, s.executor.dtype, s._vmap_dev
    d = a1.data
    a1c = CSC(a1.n, a1.indptr.copy(), a1.indices.copy(), d)
    out = {
        "dims": dims, "nnz": int(a1.nnz), "analyze_s": analyze_s,
        "bit_identical": bool(same),
        "host_permute_ms": _ms(lambda: a1.permute(s.perm).data, 5),
        "cast_then_upload_gather_ms": _ms(
            lambda: torch.as_tensor(d).to(device=dev, dtype=dt)
            .index_select(0, vm), 30),
        "upload_then_cast_gather_ms": _ms(
            lambda: torch.as_tensor(d).to(dev).to(dt).index_select(0, vm),
            30),
        "upload_gather_then_cast_ms": _ms(
            lambda: torch.as_tensor(d).to(dev).index_select(0, vm).to(dt),
            30),
        "pattern_check_copy_ms": _ms(lambda: s._gather_values(a1c), 10),
        "gather_values_ms": _ms(lambda: s._gather_values(a1), 30),
        "factorize_new_ms": _ms(lambda: s.factorize(a1), 10),
        "factorize_old_ms": _ms(
            lambda: (s.executor.factorize(a1.permute(s.perm).data),
                     s.factor_ok()), 10),
    }
    del s
    torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dims", action="append",
                    help="grid dims, comma-separated (repeatable)")
    ap.add_argument("--seed", type=int, default=2147500999)
    args = ap.parse_args(argv)
    dims = [[int(x) for x in d.split(",")]
            for d in (args.dims or ["48,48,48", "1000,1000"])]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), torch.__version__,
          flush=True)
    for d in dims:
        print(json.dumps(check(d, args.seed)), flush=True)


if __name__ == "__main__":
    main()
