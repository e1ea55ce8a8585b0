#!/usr/bin/env python3
"""The leveled solves' scatter entries, counted from the plan's tables of
each benchmark configuration, on the host (no device):

    python3 tools/solve_scatter_count.py [--config grid3d_7pt_110k ...]

For each configuration of ``BENCHMARK.json`` (its matrix from the
benchmark's own generator, ``benchmark/<kind>.py``, its ``SolverConfig``
fields, the analysis ``CholeskySolver`` runs) it prints one JSON line of
what one ``solve_spd`` scatters:

* ``landed``: the real entries, ``solve_scatter_lists`` of every finalize
  bucket: x's columns (``dx``, the forward and the backward solve) and
  the rows below the panels (``dbc``, the forward solve's right-hand-side
  updates);
* ``padded``: the entries sent to a pad slot, none;
* ``padded_all_lanes``: what landing every lane of the padded (P, c) and
  (P, H) blocks would send to the pad slot n, as the solves did before
  the lists (``dx`` both directions, ``dbc``).

The matrix is made from one value set (the pattern does not depend on the
seed).  A configuration at 715,176 unknowns takes about a minute and some
GB of host memory.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402
from parsy_bench_tpu_torch.config import SolverConfig  # noqa: E402
from parsy_bench_tpu_torch.core.csc import CSC  # noqa: E402
from parsy_bench_tpu_torch.ops.supernodal import (  # noqa: E402
    solve_scatter_lists)
from parsy_bench_tpu_torch.symbolic.colcounts import col_counts  # noqa: E402
from parsy_bench_tpu_torch.symbolic.etree import etree, postorder  # noqa: E402
from parsy_bench_tpu_torch.symbolic.ordering import (  # noqa: E402
    compute_ordering)
from parsy_bench_tpu_torch.symbolic.splan import (  # noqa: E402
    build_supernodal_plan)


def plan_of(a: CSC, config: SolverConfig):
    """The supernodal plan ``CholeskySolver(a, config)`` builds: the
    fill-reducing ordering composed with the weighted postorder of the
    etree, then the plan of the permuted lower half."""
    if not a.is_lower():
        a = a.lower_half()
    fill = compute_ordering(a, config.ordering, config.given_perm)
    ap1 = a.permute(fill)
    parent1 = etree(ap1)
    post = postorder(parent1, weights=col_counts(ap1, parent1))
    ap = ap1.permute(post)
    parent = etree(ap)
    return build_supernodal_plan(ap, parent, col_counts(ap, parent), None,
                                 config)


def counts(plan) -> dict:
    """Entries one ``solve_spd`` scatters, from the plan's finalize
    buckets."""
    n = plan.n
    cols = rows = cells_c = cells_h = 0
    for seg in plan.segments:
        for b in seg.fin:
            _, ccol, _, _, rrow, _ = solve_scatter_lists(
                b.w, b.cols0, b.rows, b.c, n)
            cols += ccol.size
            rows += rrow.size
            cells_c += seg.nsteps * b.P * b.c
            cells_h += seg.nsteps * b.P * b.H
    return {"n": n, "level_steps": int(sum(s.nsteps for s in plan.segments)),
            "landed": {"dx": 2 * cols, "dbc": rows,
                       "total": 2 * cols + rows},
            "padded": 0,
            "padded_all_lanes": {"dx": 2 * (cells_c - cols),
                                 "dbc": cells_h - rows}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", action="append",
                    help="a configuration of BENCHMARK.json (default: all)")
    args = ap.parse_args(argv)
    root = os.path.dirname(harness.HERE)
    bench = harness.load_json(os.path.join(root, "BENCHMARK.json"))
    for entry in bench["configs"]:
        if args.config and entry["name"] not in args.config:
            continue
        cfg = harness.load_json(os.path.join(root, entry["file"]))
        kind = importlib.import_module("benchmark." + cfg["matrix"]["kind"])
        pat, vals = kind.build(cfg["matrix"], np.random.default_rng(0), 1)
        t0 = time.perf_counter()
        plan = plan_of(CSC(pat.n, pat.indptr, pat.indices, vals[0]),
                       SolverConfig(**cfg["solver"]))
        out = {"config": entry["name"],
               "analyze_s": round(time.perf_counter() - t0, 3)}
        out.update(counts(plan))
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
