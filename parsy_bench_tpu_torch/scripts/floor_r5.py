"""Per-phase floor attribution of the supernodal factorize: the port's
counterpart of ``scripts/floor_r5.py``.

    python -m parsy_bench_tpu_torch.scripts.floor_r5 [--grid 48] [--reps 20]
        [--iters 3] [--segments 0,5] [--all-modes] [--device cuda]

Times ablated variants of the level steps of every segment of the real
plan, each (segment, mode) one captured program run from the segment's
restored input (``supernodal.SegmentTimer``).  Modes, as in the JAX
script:

  full         the shipped step, ``SupernodalExecutor._step``
  upd_only     updates + window subtract, no finalize (``_apply_updates``)
  fin_only     finalize only, window never updated (``_finalize``)
  einsum_only  every update bucket's operand gathers and both products
               (``supernodal.update_block``), nothing landed
  gather_only  ladder gathers + assembly over real pool rows (no products)

Marginals: assembly = upd_only - einsum_only; einsums_gathers =
einsum_only; finalize = full - upd_only; fin_only; with ``--all-modes``
gather_assembly_alone = gather_only.  ``totals_s`` and ``marginals_s``
cover only the modes that ran, and ``gather_only`` tiles the rows of a
pool's (R, c) view: the JAX script reads gather_only's total without
running it (scripts/floor_r5.py:172) and tiles the packed (R/8, 8c) rows,
whose sums cannot be stacked with its (1, c) zero row (:93-102).  Neither
fault is repaired there.

Beside the JAX keys the line holds ``restore_s`` (per run, summed over the
timed segments), ``layers_ms`` (per scope of ``SCOPES``, the device ms of
one profiled ``_factorize_eager`` and the clone of its pools, in the
scopes the executor's step runs its pieces in; its ``busy`` ms, ``other``
(busy no scope covers) and one replayed ``factorize``'s busy ms),
``layers`` (its operation count, ``other``'s top names and the scopes
opened inside another, ``nested``), ``k1_launches`` (per mode, K1's
launches over the timed segments from the captures, from the profiler by
kernel name and by the plan, with the profiles taken, ``tries``),
``full_vs_eager`` (the chained ``full`` programs against the profiled
``_factorize_eager``) and ``card``.  No number is rounded.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from parsy_bench_tpu_torch import bench
from parsy_bench_tpu_torch.ops import supernodal, trace
from parsy_bench_tpu_torch.ops.device import resolve_device
from parsy_bench_tpu_torch.scripts import attribution

#: ``layers_ms``'s scopes: the executor's (``supernodal.SCOPES``) and the
#: clone of the pools that ends ``factorize`` (``_pools_out``)
SCOPES = supernodal.SCOPES + ("clone",)
MODES = ("full", "upd_only", "fin_only", "einsum_only")
ALL_MODES = MODES + ("gather_only",)
#: the modes that finalize, and so launch K1
K1_MODES = ("full", "fin_only")

_scope = trace.span


def einsums(ex, pools, seg, tabs, t):
    """einsum_only: ``update_block`` of every update bucket of step t (the
    operand gathers and both products); the windows are left as they
    were.  A replay runs every kernel its capture recorded, so nothing
    needs to read the products (JAX's ``0 * acc``)."""
    for b, ut in zip(seg.upd, tabs.upd):
        supernodal.update_block(pools[b.kcls], ut.a8[t], ut.b8[t],
                                ut.colq[t], b, ex._ar, ex.dtype)


def gathers(ex, pools, seg, tabs, t):
    """gather_only: the ladder sums and the window take and subtract of
    step t over a call buffer of the class's real pool rows: the rows of
    its (R, c) view tiled to the buffer's length (1 + the contribution
    rows)."""
    if tabs.gsc is None:
        return
    wins = ex._windows(pools, seg, tabs, t)
    for ci, c in enumerate(ex.classes):
        ent = tabs.gsc[ci]
        if ent is None:
            continue
        ntot = 1 + sum(ut.a8.shape[1] * b.Mc
                       for b, ut in zip(seg.upd, tabs.upd) if b.ccls == ci)
        rows = pools[ci].view(-1, c)
        R = rows.shape[0]
        call = torch.cat([rows] * (ntot // R) + [rows[:ntot % R]])
        zero = torch.zeros((1, c), dtype=ex.dtype, device=ex.device)
        parts = [zero] + [call[gi[t]].sum(dim=1) for gi in ent["gidx"]]
        wins[ci].sub_(torch.cat(parts)[ent["pidx"][t]])


#: mode -> step t of a segment on ``pools``: ``full``, ``upd_only`` and
#: ``fin_only`` are the executor's own step and its two phases
STEPS = {
    "full": lambda ex, pools, seg, tabs, t: ex._step(pools, seg, tabs, t),
    "upd_only": lambda ex, pools, seg, tabs, t: ex._apply_updates(
        pools, ex._windows(pools, seg, tabs, t), seg, tabs, t),
    "fin_only": lambda ex, pools, seg, tabs, t: ex._finalize(
        ex._windows(pools, seg, tabs, t), seg, tabs, t),
    "einsum_only": einsums,
    "gather_only": gathers,
}


def segment_body(ex, i, mode, pools=None):
    """Closure: every level step of segment i in ``mode`` on ``pools``
    (the executor's static pools by default)."""
    seg, tabs = ex.plan.segments[i], ex._segs[i]
    step = STEPS[mode]

    def run():
        P = ex._pools if pools is None else pools
        for t in range(seg.nsteps):
            step(ex, P, seg, tabs, t)
    return run


def _agree(name, pools, ref, pscale):
    """Bit for bit, else within 1e-6 of the pool scale (flagged)."""
    bit = all(torch.equal(p, q) for p, q in zip(pools, ref))
    d = max(float((p - q).abs().max()) for p, q in zip(pools, ref))
    if not d <= 1e-6 * pscale:
        raise AssertionError(f"{name}: pools differ from _factorize_eager's "
                             f"by {d:.3e} > 1e-6 * {pscale:.3e}")
    return dict(bit_equal=bit, max_abs_diff=d)


def run(solver, device="cuda", reps=20, iters=3, segments=None,
        all_modes=False) -> dict:
    """The attribution on ``solver``'s plan (an executor of its own on
    ``device``): the line's keys (module docstring).  ``segments``: the
    segments to time (all by default); every segment runs, so the chained
    ``full`` programs give the factor.  Raises where the full pools differ
    from ``_factorize_eager``'s beyond 1e-6 of their scale and, on the
    card, where K1's launches in a mode differ from the plan's."""
    dev = resolve_device(device)
    ex = attribution.own_executor(solver, dev)
    nseg = len(ex.plan.segments)
    sel = sorted(set(range(nseg) if segments is None else segments))
    if not all(0 <= i < nseg for i in sel):
        raise ValueError(f"segments {sel} outside [0, {nseg})")
    modes = ALL_MODES if all_modes else MODES
    a = attribution.a_values(ex, solver)
    timer = supernodal.SegmentTimer(ex, a, "floor_r5", iters, reps)
    rows, progs = [], {m: [] for m in modes}
    for i, seg in enumerate(ex.plan.segments):
        timer.begin(i)
        real = timer.program("full", segment_body(ex, i, "full"))
        if i in sel:
            mine = {m: real if m == "full" else
                    timer.program(m, segment_body(ex, i, m)) for m in modes}
            times, restore_s = timer.time(mine)
            rows.append({"segment": i, "steps": seg.nsteps,
                         "upd_buckets": len(seg.upd),
                         "fin_buckets": len(seg.fin), **times,
                         "restore_s": restore_s})
            for m in modes:
                progs[m].append(mine[m])
        real.run()      # the pools then hold the next segment's input

    # the full programs' factor against one profiled ``_factorize_eager``
    # (the executor's op-by-op factorize, its steps in their scopes)
    chained = [p.clone() for p in ex._pools]
    eager = []

    def scoped_pass():
        pools = ex._factorize_eager(a)
        with _scope("clone"):
            eager[:] = [p.clone() for p in pools]
    prof = attribution.scope_ms(scoped_pass, SCOPES, dev,
                                unlinked={"fin.k1": attribution.K1_NAMES})
    pscale = max(float(p.abs().max()) for p in eager)
    checks = dict(programs=_agree("floor_r5 full programs", chained, eager,
                                  pscale),
                  pool_scale=pscale)
    replay = attribution.device_ops(lambda: ex.factorize(a), dev)

    # K1 per mode over the timed segments: captures, profiler, plan (the
    # profiled replays overwrite the pools: after the checks above)
    k1 = {}
    for m in modes:
        plan_n = (sum(attribution.k1_calls(ex, i) for i in sel)
                  if m in K1_MODES else 0)
        got = attribution.device_ops(
            lambda: [p.run() for p in progs[m]], dev,
            kernel=attribution.K1_NAMES,
            expect=plan_n if dev.type == "cuda" else None)
        k1[m] = dict(plan=plan_n, profiled=got["k_n"], tries=got["tries"],
                     capture=sum(p.launches[attribution.K1_WRAPPER]
                                 for p in progs[m]))
        if dev.type == "cuda" and not (
                k1[m]["capture"] == k1[m]["profiled"] == plan_n):
            raise AssertionError(f"floor_r5 {m}: K1 launches {k1[m]}")

    tot = {m: sum(r[m] for r in rows) for m in modes}
    marg = {"assembly": tot["upd_only"] - tot["einsum_only"],
            "einsums_gathers": tot["einsum_only"]}
    if "gather_only" in tot:
        marg["gather_assembly_alone"] = tot["gather_only"]
    marg.update(finalize=tot["full"] - tot["upd_only"],
                fin_only=tot["fin_only"])
    return {"n": int(ex.plan.n), "nseg": nseg, "reps": reps,
            "segments_timed": sel, "totals_s": tot, "marginals_s": marg,
            "segments": rows,
            "restore_s": sum(r["restore_s"] for r in rows),
            "layers_ms": dict(prof["scopes"], busy=prof["busy"],
                              other=prof["other"],
                              replayed_factorize_busy=replay["busy_ms"]),
            "layers": dict(ops=prof["ops"], other_top=prof["other_top"],
                           nested=prof["nested"],
                           wall_ms=prof["wall_ms"],
                           replayed_factorize_ops=replay["ops"]),
            "k1_launches": k1, "full_vs_eager": checks, "iters": iters,
            "card": bench._card() if dev.type == "cuda" else "cpu"}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=48)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--segments", type=str, default="")
    ap.add_argument("--all-modes", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    _, solver, _ = bench.analyze(args.grid, dev)
    out = run(solver, dev, reps=args.reps, iters=args.iters,
              segments=([int(s) for s in args.segments.split(",")]
                        if args.segments else None),
              all_modes=args.all_modes)
    for r in out["segments"]:
        print(json.dumps(r), file=sys.stderr)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
