"""Finalize-phase sub-ablation at one segment: the port's counterpart of
``scripts/fin_ablate.py`` (default segment 0, the leaf level, where K1's
batch at ``laplace_3d(48)`` is (27,520, 32)).

    python -m parsy_bench_tpu_torch.scripts.fin_ablate [--segment 0]
        [--reps 10] [--iters 3] [--grid 48] [--device cuda]

Times the finalize of the segment's level steps with pieces knocked out,
each mode one captured program run from the segment's restored input
(``attribution.SegmentTimer``), as in the JAX script:

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

The four knocked-out modes run ``finalize``, this module's copy of the
unfused ``_finalize`` with the piece taken out; with nothing taken out it
is bit-equal to the executor's (held so on the CPU).

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


def finalize(ex, wins, seg, tabs, t, chol=None, tail=True, diff=None):
    """The unfused ``SupernodalExecutor._finalize`` of step t with a piece
    taken out: ``chol`` in place of ``supernodal.chol_inverse`` (K1 on the
    card), ``tail=False`` stops after the Cholesky and leaves the windows
    as they were, ``diff`` in place of ``dense.finalize_diff``."""
    chol = chol or supernodal.chol_inverse
    diff = diff or dense.finalize_diff
    for ci, c in enumerate(ex.classes):
        groups = tabs.fin_groups[ci]
        if not groups:
            continue
        win = wins[ci]
        blks, ws = {}, {}
        for grp in groups:
            for k in grp:
                b, ft = seg.fin[k], tabs.fin[k]
                off = int(ft.boff[t])
                blks[k] = win[off:off + b.P * b.H].view(b.P, b.H, c)
                ws[k] = ft.w[t]
        if tail:
            delta = torch.zeros_like(win)
        Ls, Linvs = {}, {}
        for grp in groups:
            D = dense.masked_spd(torch.cat([blks[k][:, :c, :] for k in grp]),
                                 torch.cat([ws[k] for k in grp]), c, ex.dtype)
            Lg, Lig = chol(D)
            off = 0
            for k in grp:
                Pk = seg.fin[k].P
                Ls[k] = Lg[off:off + Pk]
                Linvs[k] = Lig[off:off + Pk]
                off += Pk
        if not tail:
            continue
        for k in sorted(blks):
            b, ft = seg.fin[k], tabs.fin[k]
            d = diff(blks[k], ws[k], int(ft.cnt[t]), Ls[k], Linvs[k])
            off = int(ft.boff[t])
            delta[off:off + b.P * b.H] += d.view(-1, c)
        win += delta


#: mode -> the finalize of step t on the windows ``wins``
VARIANTS = {
    "full": lambda ex, wins, seg, tabs, t: ex._finalize(wins, seg, tabs, t),
    "nochol": lambda *a: finalize(*a, chol=lambda D: (D, D)),
    "xlachol": lambda *a: finalize(*a, chol=dense.cholesky_inverse),
    "cholonly": lambda *a: finalize(*a, tail=False),
    "noy": lambda *a: finalize(*a, diff=_diff_noy),
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
    timer = attribution.SegmentTimer(ex, attribution.a_values(ex, solver),
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
