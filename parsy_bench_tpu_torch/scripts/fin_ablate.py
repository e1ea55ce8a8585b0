"""Finalize-phase sub-ablation at one segment: the port's counterpart of
``scripts/fin_ablate.py`` (default segment 0, the leaf level, where K1's
batch at ``laplace_3d(48)`` is (27,520, 32)).

    python -m parsy_bench_tpu_torch.scripts.fin_ablate [--segment 0]
        [--reps 10] [--iters 3] [--grid 48] [--device cuda]

Times the finalize of the segment's level steps with pieces knocked out,
each mode one captured program run from the segment's restored input
(``supernodal.SegmentTimer``), as in the JAX script:

  full       the shipped finalize, ``SupernodalExecutor._finalize``
  nochol     the Cholesky replaced by (D, D) passthrough
  xlachol    the plain version ``dense.cholesky_inverse`` in place of K1,
             on the card too (the JAX script's ``PBT_DISABLE_PALLAS``
             route): K1's margin inside the real finalize
  cholonly   masked SPD + Cholesky alone (no Y product, no deltas): the
             windows stay as they were
  noy        full minus the Y product (Y := blk)
  slices     window slice + unslice only.  The port's windows are views
             into the pools (``_rows_view``), so this launches nothing: it
             reads 0.0, and ``slices_ops`` counts its device operations
             (0) in a profile.

The four knocked-out modes run the executor's own finalize body,
``ops/supernodal.fin_inverses`` then ``fin_land``, with the piece swapped
(``chol`` of the first, ``diff`` of the second) or the second left out;
with nothing swapped it is bit-equal to the executor's (held so on the
CPU).

Beside the JAX keys (``segment``, ``fin`` and one per mode) the line holds
``restore_s``, ``k1_launches`` (per mode: captures, profiler, plan and
the profiles taken, ``tries``), ``slices_ops``, ``reps``, ``iters`` and
``card``.  No number is rounded.
"""
from __future__ import annotations

import argparse
import json

import torch

from parsy_bench_tpu_torch import bench
from parsy_bench_tpu_torch.ops import dense, supernodal
from parsy_bench_tpu_torch.ops.device import resolve_device
from parsy_bench_tpu_torch.scripts import attribution

MODES = ("full", "nochol", "xlachol", "cholonly", "noy", "slices")
#: the modes that launch K1
K1_MODES = ("full", "cholonly", "noy")


def _diff_noy(blk, w, cnt, L, Linv):
    """``dense.finalize_diff`` with Y := blk (no product with Linv^T)."""
    c = blk.shape[2]
    ar = torch.arange(c, device=blk.device)
    i_c = ar[None, :, None]
    j_c = ar[None, None, :]
    wv = w[:, None, None]
    valid = (i_c < wv) & (j_c < wv)
    Ltop = (L.masked_fill(~valid, 0)
            + Linv.transpose(1, 2).masked_fill(~(valid & (j_c > i_c)), 0))
    Y = blk.masked_fill(~(j_c < wv), 0)
    top = torch.where(i_c < wv, Ltop, Y[:, :c, :])
    diff = torch.cat([top, Y[:, c:, :]], dim=1) - blk
    diff[int(cnt):] = 0
    return diff


def _classes(wins, seg, tabs, t):
    """Per class with chol groups: (its window, its buckets'
    ``supernodal.fin_lanes`` per chol group)."""
    return [(wins[ci], [[supernodal.fin_lanes(wins[ci], seg.fin[k],
                                              tabs.fin[k], t) for k in grp]
                        for grp in groups])
            for ci, groups in enumerate(tabs.fin_groups) if groups]


def _swapped(chol=None, diff=None):
    """The executor's unfused finalize body with ``chol`` in place of
    ``supernodal.chol_inverse`` (K1 on the card) or ``diff`` in place of
    ``dense.finalize_diff``."""
    def fin(ex, wins, seg, tabs, t):
        for win, groups in _classes(wins, seg, tabs, t):
            delta = torch.zeros_like(win)
            facs = supernodal.fin_inverses(groups, ex.dtype, chol)
            supernodal.fin_land(win, delta, [x for g in groups for x in g],
                                facs, diff=diff)
    return fin


def _cholonly(ex, wins, seg, tabs, t):
    """The first half alone: the windows stay as they were."""
    for _, groups in _classes(wins, seg, tabs, t):
        supernodal.fin_inverses(groups, ex.dtype)


#: mode -> the finalize of step t on the windows ``wins``: the executor's
#: own, or its body (``supernodal.fin_inverses`` then ``fin_land``) with
#: a piece swapped or left out
VARIANTS = {
    "full": lambda ex, wins, seg, tabs, t: ex._finalize(wins, seg, tabs, t),
    "nochol": _swapped(chol=lambda D: (D, D)),
    "xlachol": _swapped(chol=dense.cholesky_inverse),
    "cholonly": _cholonly,
    "noy": _swapped(diff=_diff_noy),
}


def segment_body(ex, i, mode):
    """Closure: the finalize of every level step of segment i in
    ``mode`` on the static pools."""
    seg, tabs = ex.plan.segments[i], ex._segs[i]
    fin = VARIANTS[mode]

    def run():
        for t in range(seg.nsteps):
            fin(ex, ex._windows(ex._pools, seg, tabs, t), seg, tabs, t)
    return run


def run(solver, device="cuda", segment=0, reps=10, iters=3) -> dict:
    """The sub-ablation at ``segment`` of ``solver``'s plan (an executor
    of its own on ``device``): the line's keys (module docstring).  Raises
    on the card where K1's launches in a mode differ from the plan's."""
    dev = resolve_device(device)
    ex = attribution.own_executor(solver, dev)
    nseg = len(ex.plan.segments)
    if not 0 <= segment < nseg:
        raise ValueError(f"segment {segment} outside [0, {nseg})")
    seg, tabs = ex.plan.segments[segment], ex._segs[segment]
    timer = supernodal.SegmentTimer(ex, attribution.a_values(ex, solver),
                                    "fin_ablate", iters, reps)
    ex._chain(0, segment)()         # the pools then hold the segment's input
    timer.begin(segment)
    progs = {m: timer.program(m, segment_body(ex, segment, m))
             for m in VARIANTS}
    times, restore_s = timer.time(progs)
    slices = attribution.device_ops(
        lambda: [ex._windows(ex._pools, seg, tabs, t)
                 for t in range(seg.nsteps)], dev)
    k1 = {}
    for m, p in progs.items():
        plan_n = attribution.k1_calls(ex, segment) if m in K1_MODES else 0
        got = attribution.device_ops(
            p.run, dev, kernel=attribution.K1_NAMES,
            expect=plan_n if dev.type == "cuda" else None)
        k1[m] = dict(plan=plan_n, profiled=got["k_n"], tries=got["tries"],
                     capture=p.launches[attribution.K1_WRAPPER])
        if dev.type == "cuda" and not (
                k1[m]["capture"] == k1[m]["profiled"] == plan_n):
            raise AssertionError(f"fin_ablate {m}: K1 launches {k1[m]}")
    return {"segment": segment,
            "fin": [(b.ccls, b.c, b.H, b.P) for b in seg.fin],
            **times, "slices": 0.0, "restore_s": restore_s,
            "k1_launches": k1, "slices_ops": slices["ops"], "reps": reps,
            "iters": iters,
            "card": bench._card() if dev.type == "cuda" else "cpu"}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--segment", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--grid", type=int, default=48)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    _, solver, _ = bench.analyze(args.grid, dev)
    print(json.dumps(run(solver, dev, segment=args.segment, reps=args.reps,
                         iters=args.iters)))


if __name__ == "__main__":
    main()
