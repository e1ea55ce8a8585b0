"""End-to-end schedule-validity verification of a SupernodalPlan.

The reference verifies every LBC schedule it emits: the flattened
(levelPtr, parPtr, partition) output must cover each node exactly once and
respect dependency order (InspectionLevel_06.h:354-371;
Inspection_DAG_02.h:263-278).  ``verify_plan`` is the equivalent for the
TPU plan contract (symbolic/splan.py): it decodes the emitted device index
tables back into supernode identities and checks

* **coverage** — every supernode is finalized exactly once, at the step of
  its wavefront level; every below-diagonal row of every update pair
  contributes exactly once (no dropped or duplicated chunk rows);
* **dependency order** — every update source panel is finalized at a
  strictly earlier step than the step that consumes it;
* **window containment** — finalize slices and update destination rows stay
  inside the per-segment window (padding only ever writes the dummy row),
  and windows stay inside the pools.

Runs on the host in O(plan size); wired under ``SolverConfig.verify``.

The port's own copy of ``parsy_bench_tpu/symbolic/verify.py`` (the
reference); only the package in its imports differs.
"""
from __future__ import annotations

import numpy as np

from parsy_bench_tpu_torch.symbolic.splan import SupernodalPlan


class PlanError(AssertionError):
    pass


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise PlanError(msg)


def verify_plan(plan: SupernodalPlan) -> dict:
    """Raise PlanError on any violated invariant; return summary stats."""
    lay = plan.layout
    part = lay.part
    n = plan.n
    nsuper = part.nsuper
    lev = plan.lev
    ncls = lay.ncls
    classes = lay.classes

    # pool row -> supernode decoder, per class
    dec_off = []   # sorted rowoff per class
    dec_sup = []
    for ci in range(ncls):
        sel = np.nonzero(lay.cls == ci)[0]
        order = np.argsort(lay.rowoff[sel], kind="stable")
        dec_off.append(lay.rowoff[sel][order])
        dec_sup.append(sel[order])

    def sup_of_rows(ci, rows):
        """Supernode owning each pool row (rows must be panel-start-aligned
        or interior); -1 for out-of-pool rows."""
        k = np.searchsorted(dec_off[ci], rows, side="right") - 1
        ok = (k >= 0) & (k < len(dec_sup[ci]))
        s = np.where(ok, dec_sup[ci][np.clip(k, 0, None)], -1)
        inside = ok & (rows < lay.rowoff[s] + lay.hpad[s])
        return np.where(inside, s, -1)

    # ---------------------------------------------------------- finalize
    seen = np.zeros(nsuper, dtype=np.int64)
    t_base = 0
    fin_step = np.full(nsuper, -1, dtype=np.int64)   # global step index
    for si, seg in enumerate(plan.segments):
        T = seg.nsteps
        for b in seg.fin:
            _check(b.ccls < ncls and b.c == classes[b.ccls],
                   f"seg{si}: fin bucket class mismatch")
            for t in range(T):
                cnt = int(b.cnt[t])
                _check(cnt <= b.P, f"seg{si}: cnt > P")
                if cnt == 0:
                    continue
                end = int(b.boff[t]) + b.P * b.H
                _check(end <= seg.wslice[b.ccls],
                       f"seg{si} t{t}: fin slice [boff,boff+P*H) "
                       f"exceeds window ({end} > {seg.wslice[b.ccls]})")
                # decode lanes -> supernodes via first global column
                c0 = b.cols0[t, :cnt]
                _check(np.all(c0 < n), f"seg{si} t{t}: real lane col0 pad")
                s = part.col2sup[c0]
                _check(np.array_equal(part.sptr[s], c0),
                       f"seg{si} t{t}: cols0 not supernode starts")
                _check(np.all(lay.cls[s] == b.ccls)
                       and np.all(lay.hpad[s] == b.H),
                       f"seg{si} t{t}: lane supernode class/height "
                       f"mismatch")
                _check(np.all(lev[s] == t_base + t),
                       f"seg{si} t{t}: supernode finalized off its level")
                # slice position must equal the panel's layout position
                want = (lay.rlo[b.ccls, t_base + t] + b.boff[t]
                        + np.arange(cnt) * b.H)
                _check(np.array_equal(lay.rowoff[s], want),
                       f"seg{si} t{t}: fin slice misaligned with layout")
                _check(np.array_equal(b.w[t, :cnt], part.widths[s]),
                       f"seg{si} t{t}: lane width mismatch")
                np.add.at(seen, s, 1)
                fin_step[s] = t_base + t
                # padded lanes must be inert
                _check(np.all(b.w[t, cnt:] == 0),
                       f"seg{si} t{t}: padded lane has nonzero width")
        # window containment in the pool
        for ci in range(ncls):
            hi = seg.rlo[ci].astype(np.int64) + seg.wslice[ci]
            _check(int(hi.max(initial=0)) <= int(plan.nrows[ci]),
                   f"seg{si}: window exceeds pool rows (class {ci})")
        t_base += T
    _check(np.all(seen == 1),
           f"finalize coverage: {np.sum(seen == 0)} supernodes never "
           f"finalized, {np.sum(seen > 1)} finalized more than once")

    # ----------------------------------------------------------- updates
    # re-derive the ground-truth pair list and check every below-diagonal
    # pair row is updated exactly once by the emitted chunk tables
    has_upd = any(seg.upd for seg in plan.segments)
    from parsy_bench_tpu_torch.symbolic.splan import emit_pairs
    dd, ss, lb, qq = emit_pairs(lay.rptr, lay.rows, part.sptr, part.col2sup)
    mm = (lay.rptr[dd + 1] - lay.rptr[dd] - lb).astype(np.int64)
    pair_key = dd.astype(np.int64) * nsuper + ss
    p_order = np.argsort(pair_key, kind="stable")
    key_sorted = pair_key[p_order]
    covered = np.zeros(int(mm.sum()) + 1, dtype=np.int64)
    pr_off = np.zeros(len(mm) + 1, dtype=np.int64)
    np.cumsum(mm, out=pr_off[1:])

    t_base = 0
    nchunks = 0
    for si, seg in enumerate(plan.segments):
        T = seg.nsteps
        for b in seg.upd:
            G = b.arow.shape[0]
            dummy = seg.wslice[b.ccls]
            for g in range(G):
                for t in range(T):
                    ar = b.arow[g, t].astype(np.int64)
                    br = b.brow[g, t].astype(np.int64)
                    dst = b.dst[g, t].astype(np.int64)
                    real = np.any(dst != dummy, axis=1)
                    if not np.any(real):
                        continue
                    nchunks += int(real.sum())
                    ar, br, dst = ar[real], br[real], dst[real]
                    # packed-gather invariant: chunk/operand starts are
                    # 8-aligned (splan PACK alignment)
                    _check(np.all(ar % 8 == 0) and np.all(br % 8 == 0),
                           f"seg{si} t{t}: chunk start not 8-aligned")
                    # real dst entries form one contiguous run starting
                    # at the chunk's alignment shift
                    mask = dst != dummy
                    cnt_rows = mask.sum(axis=1)
                    j0 = np.argmax(mask, axis=1)
                    cols = np.arange(dst.shape[1])
                    _check(np.array_equal(
                        mask, (cols[None, :] >= j0[:, None])
                        & (cols[None, :] < (j0 + cnt_rows)[:, None])),
                        f"seg{si} t{t}: chunk dst mask not a single run")
                    # the first real source row decodes the source panel
                    d = sup_of_rows(b.kcls, ar + j0)
                    _check(np.all(d >= 0),
                           f"seg{si}: chunk rows outside any panel")
                    # dependency: source finalized strictly earlier
                    _check(np.all(fin_step[d] < t_base + t),
                           f"seg{si} t{t}: update reads a source panel "
                           f"not yet finalized")
                    _check(np.all(dst[mask] >= 0)
                           and np.all(dst[mask] < dummy),
                           f"seg{si} t{t}: dst row outside window")
                    gl = dst + lay.rlo[b.ccls, t_base + t]
                    s2 = sup_of_rows(b.ccls, np.where(mask, gl, 0))
                    _check(np.all(lev[s2[mask]] == t_base + t),
                           f"seg{si} t{t}: dst row not on current level")
                    # pair identity (d, first target supernode) must exist
                    rows_idx = np.arange(len(j0))
                    want = d * np.int64(nsuper) + s2[rows_idx, j0]
                    k = np.searchsorted(key_sorted, want)
                    _check(np.all(k < len(key_sorted)) and np.all(
                        key_sorted[np.clip(k, 0, len(key_sorted) - 1)]
                        == want),
                        f"seg{si} t{t}: chunk matches no emitted pair")
                    pidx = p_order[k]
                    off_in_pair = (ar + j0 - lay.rowoff[d] - lb[pidx])
                    _check(np.all(off_in_pair >= 0)
                           and np.all(off_in_pair + cnt_rows
                                      <= mm[pidx]),
                           f"seg{si} t{t}: chunk rows outside pair range")
                    flat0 = pr_off[pidx] + off_in_pair - j0
                    np.add.at(covered,
                              (flat0[:, None]
                               + np.arange(dst.shape[1])[None, :])[mask],
                              1)
        t_base += T
    if has_upd:
        _check(np.all(covered[:-1] == 1),
               f"update coverage: {np.sum(covered[:-1] == 0)} pair rows "
               f"never updated, {np.sum(covered[:-1] > 1)} duplicated")

    return {"nsuper": int(nsuper), "npairs": int(len(dd)),
            "pair_rows": int(mm.sum()), "chunks": nchunks,
            "segments": len(plan.segments), "ok": True}
