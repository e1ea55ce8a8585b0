"""Distributed (ownership-partitioned) supernodal plan.

The single-device plan (splan.py) stores the factor in shared per-class
row pools.  Here every supernode is owned by one device
(symbolic/partition.py): device g's pools hold ONLY its panels, laid out
level-major like the single-device layout, so per-device factor memory
shrinks ~1/G.  All executor tables lead with the device axis G and are
sharded over the mesh (one slice per device):

* **updates** run on the owner of the SOURCE panel (its rows are local);
  a chunk whose target has the same owner scatters into the local level
  window; a cross-owner chunk scatters into a per-class **boundary send
  buffer** slot addressed (target owner, slot);
* one **ragged psum** per (class, level step) reduces the send buffers
  over a ragged per-receiver layout (a receiver-padded psum_scatter
  would pad to the hot receiver of the top-separator steps); each
  device then slices its OWN boundary rows (Bc rows, not
  the whole window) out of the reduced buffer — the boundary-only collective
  that replaces the reference's shared-memory scatter and the round-3
  full-window psum (SURVEY §7E; computeComCost's inter-partition nnz,
  performanceModel.h:194);
* **finalize** is purely local: each device factors its own panels.

The emission mirrors splan.plan_from_layout with per-device coordinates;
bucket lane counts and window sizes are padded to the max across devices
so the SPMD program is shape-identical everywhere.

The port's own copy of ``parsy_bench_tpu/symbolic/dplan.py`` (the
reference), as ``splan.py`` is: only the imports differ, and
``segment_levels`` comes from ``parsy_bench_tpu_torch/ops/simplicial.py``.
``tests/test_torch_parallel.py`` holds every array of its plan equal to
the reference's.  The port's "device" is a rank process
(``parallel/comm.py``), and its "mesh psum" an ``all_reduce``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from parsy_bench_tpu_torch.core.csc import CSC
from parsy_bench_tpu_torch.config import SolverConfig
from parsy_bench_tpu_torch.ops.simplicial import segment_levels
from parsy_bench_tpu_torch.symbolic.etree import tree_levels
from parsy_bench_tpu_torch.symbolic.partition import (
    partition_supernodes, supernode_costs)
from parsy_bench_tpu_torch.symbolic.splan import (
    _chunk_pairs, _cumsum0, _expand, _group_ranks, emit_pairs, slack_levels)
from parsy_bench_tpu_torch.symbolic.supernodes import (
    _height_class, build_partition, supernodal_rows,
    supernodal_rows_from_etree)


@dataclasses.dataclass
class DUpdBucket:
    """Update chunk batch; same einsum contract as splan.UpdBucket but
    dst addresses the extended delta [local window | G x Bc send | dummy]."""
    kcls: int
    K: int
    ccls: int
    c: int
    Mc: int
    Q: int
    arow: np.ndarray     # (G, T, P) device-local first source row
    brow: np.ndarray     # (G, T, P)
    colq: np.ndarray     # (G, T, P, Q)
    dst: np.ndarray      # (G, T, P, Mc) extended-delta row


@dataclasses.dataclass
class DFinBucket:
    """Per-device finalize slice of panels with equal (class, height)."""
    ccls: int
    c: int
    H: int
    P: int
    cnt: np.ndarray      # (G, T)
    boff: np.ndarray     # (G, T) local-window offset of the slice
    w: np.ndarray        # (G, T, P)
    cols0: np.ndarray    # (G, T, P) pad -> n
    rows: np.ndarray     # (G, T, P, H) pad -> n


@dataclasses.dataclass
class DSegment:
    nsteps: int
    upd: list
    fin: list
    rlo: np.ndarray      # (G, T, ncls) per-device window starts
    wslice: tuple        # per class: max local window rows (static)
    bc: tuple            # per class: max own boundary slots (static)
    btot: tuple          # per class: ragged boundary buffer rows (static)
    brows: list          # per class: (G, T, bc) receiver local window row,
    #                      pad -> wslice[ci] (the padded window dummy row)
    boff: list           # per class: (G, T) own offset into the ragged
    #                      boundary buffer

    # ---- solve-side boundary exchange (SURVEY §7E halo x-segments;
    # replaces the round-4 full-(n+1)-vector psums per step).
    # LOWER solve: cross-owner RHS contributions ride one ragged psum per
    # step, keyed (receiver, source step, global row); each fin bucket's
    # ``rdst`` addresses an extended delta [n+1 local | slots | dummy].
    sl_btot: int = 1     # ragged send-buffer rows (static)
    sl_bc: int = 1       # max own slots per (device, step) (static)
    sl_boff: np.ndarray | None = None   # (G, T) own offset
    sl_rows: np.ndarray | None = None   # (G, T, sl_bc) global row, pad -> n
    sl_rdst: list = dataclasses.field(default_factory=list)
    #                      per fin bucket: (G, T, P, H) extended-delta pos
    # UPPER solve: x-value delivery, keyed (reader, source step, row).
    # The column owner gathers its freshly solved x entries into slots
    # (su_slot/su_srow, sender side); readers copy their slice into their
    # local x (su_rows, receiver side).
    su_btot: int = 1
    su_ks: int = 1       # max slots a sender fills per step (static)
    su_slot: np.ndarray | None = None   # (G, T, su_ks) slot pos, pad->btot
    su_srow: np.ndarray | None = None   # (G, T, su_ks) global row, pad -> n
    su_bc: int = 1
    su_boff: np.ndarray | None = None   # (G, T) reader offset
    su_rows: np.ndarray | None = None   # (G, T, su_bc) global row, pad -> n


@dataclasses.dataclass
class DistPlan:
    n: int
    G: int
    classes: tuple
    segments: list
    nrows: np.ndarray    # (ncls,) per-device pool rows (max over devices)
    a_map: list          # per class: (G, 2, k) [local flat pos; a index]
    flops: float
    owner: np.ndarray    # (nsuper,) owning device (diagnostics)
    comm: dict           # boundary statistics (computeComCost analog)
    layout_meta: dict    # per-device extraction info for verification
    owner_col: np.ndarray | None = None   # (n+1,) owning device per column

    @property
    def ncls(self):
        return len(self.classes)

    def pool_elems_per_device(self) -> int:
        return int(sum(int(r) * c for r, c in zip(self.nrows, self.classes)))

    def psum_bytes_per_step(self) -> dict:
        """Modeled collective payload per device: the ragged boundary
        buffer rides one psum per (class, step) — ring cost
        2*(G-1)/G * btot rows sent+received per device; the receive
        MINIMUM (a device's own boundary slots) is also reported (the
        SCALING artifact's comm metrics; computeComCost analog)."""
        ring = 2.0 * (self.G - 1) / max(self.G, 1)
        total = 0.0
        recv_min = 0.0
        solve_l = 0.0
        solve_u = 0.0
        for seg in self.segments:
            total += seg.nsteps * ring * sum(
                bt * c * 4 for bt, c in zip(seg.btot, self.classes))
            recv_min += seg.nsteps * sum(
                bc * c * 4 for bc, c in zip(seg.bc, self.classes))
            solve_l += seg.nsteps * ring * seg.sl_btot * 4
            solve_u += seg.nsteps * ring * seg.su_btot * 4
        # one final full-x assembly psum per solve direction
        final_x = ring * (self.n + 1) * 4
        return {"factorize_bytes": total,
                "receive_min_bytes": recv_min,
                "solve_lower_bytes": solve_l + final_x,
                "solve_upper_bytes": solve_u + final_x,
                "solve_r4_design_bytes":
                    2.0 * ring * (self.n + 1) * 4
                    * sum(seg.nsteps for seg in self.segments)}


def build_dist_plan(a: CSC, parent: np.ndarray, cc: np.ndarray,
                    G: int, config: SolverConfig | None = None,
                    owner: np.ndarray | None = None) -> DistPlan:
    config = config or SolverConfig()
    n = a.n
    part = build_partition(a, parent, cc, config.nrelax, config.zrelax,
                           config.max_supernode_width)
    lev = tree_levels(part.sparent)
    try:
        rptr, rows = supernodal_rows_from_etree(a, parent, part)
    except Exception:
        from parsy_bench_tpu_torch.symbolic.colcounts import (
            symbolic_pattern)
        rptr, rows = supernodal_rows(symbolic_pattern(a, parent), part)
    if config.slack_placement:
        lev = slack_levels(part, rptr, rows, lev, config.width_classes)
    if owner is None:
        owner = partition_supernodes(part.sparent,
                                     supernode_costs(part.sptr, cc), G)
    owner = np.asarray(owner, dtype=np.int64)

    sptr = part.sptr
    nsuper = part.nsuper
    nlev = int(lev.max(initial=-1)) + 1
    classes = tuple(sorted(config.width_classes))
    ncls = len(classes)
    w_all = np.diff(sptr)
    h_all = np.diff(rptr)
    cls = np.searchsorted(np.asarray(classes), w_all)
    if cls.max(initial=0) >= ncls:
        raise ValueError(f"width {w_all.max()} exceeds largest class")
    wpad = np.asarray(classes)[cls].astype(np.int64)
    hpad = _height_class(h_all, wpad)

    # ---------------- per-device level-major layout --------------------
    rowoff = np.zeros(nsuper, dtype=np.int64)   # local offset on owner
    rlo = np.zeros((G, ncls, nlev), dtype=np.int64)
    wrows = np.zeros((G, ncls, nlev), dtype=np.int64)
    nrows_dev = np.zeros((G, ncls), dtype=np.int64)
    for g in range(G):
        for ci in range(ncls):
            sel = np.nonzero((cls == ci) & (owner == g))[0]
            order = sel[np.lexsort((sel, hpad[sel], lev[sel]))]
            sizes = hpad[order]
            offs = np.concatenate([[0], np.cumsum(sizes)])
            rowoff[order] = offs[:-1]
            nrows_dev[g, ci] = int(offs[-1])
            lv = lev[order]
            lo_i = np.searchsorted(lv, np.arange(nlev))
            hi_i = np.searchsorted(lv, np.arange(nlev) + 1)
            rlo[g, ci] = offs[np.minimum(lo_i, len(offs) - 1)]
            wrows[g, ci] = np.where(hi_i > lo_i,
                                    offs[np.minimum(hi_i, len(offs) - 1)]
                                    - rlo[g, ci], 0)

    # ---------------- A scatter maps (per device, padded) --------------
    sup_of_row = np.repeat(np.arange(nsuper, dtype=np.int64), h_all)
    row_keys = sup_of_row * np.int64(n + 1) + rows.astype(np.int64)
    acol = np.repeat(np.arange(n, dtype=np.int64), np.diff(a.indptr))
    arow_g = a.indices.astype(np.int64)
    s_of = part.col2sup.astype(np.int64)[acol]
    pos = np.searchsorted(row_keys, s_of * np.int64(n + 1) + arow_g)
    assert np.all(rows[pos] == arow_g), "A entry outside supernodal pattern"
    aflat = (rowoff[s_of] + (pos - rptr[s_of])) * wpad[s_of] \
        + (acol - sptr[s_of])
    adev = owner[s_of]
    acls = cls[s_of]
    a_map = []
    # trash row: one extra row past the per-class pool (see nrows below)
    for ci in range(ncls):
        per_dev = [np.nonzero((acls == ci) & (adev == g))[0]
                   for g in range(G)]
        k = max((len(x) for x in per_dev), default=0)
        m = np.zeros((G, 2, k), dtype=np.int64)   # filled after nrows known
        a_map.append([per_dev, m, k])

    # ---------------- update pairs + chunks ----------------------------
    dd, ss, lb, qq = emit_pairs(rptr, rows, sptr, part.col2sup)
    mm = (rptr[dd + 1] - rptr[dd] - lb).astype(np.int64)
    ridx, pair_of, intra = _expand(rptr[dd] + lb, mm)
    rv = rows[ridx].astype(np.int64)
    pos_t = np.searchsorted(row_keys, ss[pair_of] * np.int64(n + 1) + rv)
    assert np.all(rows[pos_t] == rv), "supernodal subset violated"
    # target-local window row (within owner(ss)'s window at lev[ss])
    dst_win_flat = (rowoff[ss[pair_of]] + (pos_t - rptr[ss[pair_of]])
                    - rlo[owner[ss[pair_of]], cls[ss[pair_of]],
                          lev[ss[pair_of]]]).astype(np.int64)
    pr_off = _cumsum0(mm)
    bsel = intra < qq[pair_of]
    b_colpos = (rv[bsel] - sptr[ss[pair_of[bsel]]]).astype(np.int64)
    bq_off = _cumsum0(qq)

    PACK = 8
    astart_pair = rowoff[dd] + lb
    shift = astart_pair % PACK
    m_eff = mm + shift
    qq_eff = qq + shift
    qcls_ladder = np.asarray(config.q_classes)
    if len(qq) and qcls_ladder[-1] < qq_eff.max():
        raise ValueError("q_classes must cover the widest aligned overlap")
    q_idx = np.searchsorted(qcls_ladder, qq_eff)
    qpad = qcls_ladder[q_idx]
    cpair, cmc, coff, cmtrue_eff = _chunk_pairs(m_eff, config.chunk_classes)
    col0 = np.where(coff == 0, shift[cpair], 0)
    ccnt = cmtrue_eff - col0
    cpairrow0 = coff + col0 - shift[cpair]
    ck = cls[dd[cpair]]
    cc_t = cls[ss[cpair]]
    clev = lev[ss[cpair]]
    cown = owner[dd[cpair]]            # executing device = source owner
    ctown = owner[ss[cpair]]           # receiving device = target owner
    mc_idx = np.searchsorted(-np.asarray(config.chunk_classes), -cmc)
    nq = len(config.q_classes)
    cbucket = (((ck * ncls + cc_t) * len(config.chunk_classes)
                + mc_idx) * nq + q_idx[cpair])
    nbuckets = ncls * ncls * len(config.chunk_classes) * nq

    # ---------------- segmentation (global stats) ----------------------
    fin_cnt = np.zeros((G * ncls, nlev), dtype=np.int64)
    for g in range(G):
        for ci in range(ncls):
            sel = (cls == ci) & (owner == g)
            np.add.at(fin_cnt[g * ncls + ci], lev[sel], 1)
    bcnt = np.zeros((nlev, nbuckets), dtype=np.float64)
    if len(cpair):
        lane_cost = (cmc * (wpad[dd[cpair]] + wpad[ss[cpair]])
                     ).astype(np.float64) / 64.0
        np.add.at(bcnt, (clev, cbucket), lane_cost)
    stats = np.concatenate(
        [bcnt, fin_cnt.T,
         wrows.reshape(G * ncls, nlev).T.astype(np.float64) / 64.0], axis=1)
    segs = segment_levels(stats, alpha=float(config.segment_alpha),
                          slack=4.0) if nlev else []
    seg_of_lev = np.zeros(nlev, dtype=np.int64)
    for si, (t0, t1) in enumerate(segs):
        seg_of_lev[t0:t1] = si
    cseg = seg_of_lev[clev] if len(cpair) else np.zeros(0, dtype=np.int64)

    # lanes: rank within (segment, bucket, exec device, level)
    if len(cpair):
        skey = ((cseg * nbuckets + cbucket) * G + cown) * nlev + clev
        order_c = np.lexsort((np.arange(len(cpair)), skey))
        lane = np.empty(len(cpair), dtype=np.int64)
        lane[order_c] = _group_ranks(skey[order_c])

    # ---------------- solve-side boundary structure --------------------
    # every (panel, below-diagonal row) pair once, globally: the lower
    # solve's RHS contributions and the upper solve's x reads both flow
    # along these edges (SURVEY §7E halo x-segments)
    _bstart = rptr[:-1] + w_all
    _bcnt = h_all - w_all
    bidx_g, pan_b, _ = _expand(_bstart, _bcnt)
    rb_g = rows[bidx_g].astype(np.int64)
    pow_b = owner[pan_b]
    rsup_b = part.col2sup.astype(np.int64)[rb_g]
    rown_b = owner[rsup_b]
    cross_b = pow_b != rown_b
    tp_b = lev[pan_b]
    tr_b = lev[rsup_b]
    solve_cross_slots = 0

    segments: list[DSegment] = []
    max_over = np.zeros(ncls, dtype=np.int64)
    cross_rows_total = 0
    for si, (t0, t1) in enumerate(segs):
        T = t1 - t0
        wslice = [int(wrows[:, ci, t0:t1].max(initial=0))
                  for ci in range(ncls)]

        # -------- lower-solve boundary slots (receiver = row owner,
        # keyed (receiver, panel step, global row)) ----------------------
        Np = np.int64(n + 1)
        cm = cross_b & (seg_of_lev[tp_b] == si)
        keys_l = np.unique(((rown_b[cm] * T + (tp_b[cm] - t0)) * Np
                            + rb_g[cm]))
        gt_l = keys_l // Np
        rank_l = _group_ranks(gt_l)
        sl_bc = int(rank_l.max()) + 1 if len(rank_l) else 1
        cnt_l = np.zeros((G, T), dtype=np.int64)
        if len(keys_l):
            np.add.at(cnt_l, (gt_l // T, gt_l % T), 1)
        off_l = np.zeros((G, T), dtype=np.int64)
        np.cumsum(cnt_l[:-1], axis=0, out=off_l[1:])
        sl_btot = max(int(cnt_l.sum(axis=0).max(initial=0)), 1)
        sl_rows = np.full((G, T, sl_bc), n, dtype=np.int32)
        if len(keys_l):
            sl_rows[gt_l // T, gt_l % T, rank_l] = keys_l % Np
        slot_l = off_l[gt_l // T, gt_l % T] + rank_l \
            if len(keys_l) else rank_l
        solve_cross_slots += len(keys_l)

        # -------- upper-solve delivery slots (reader = panel owner,
        # keyed (reader, source step, global row)) -----------------------
        cu = cross_b & (seg_of_lev[tr_b] == si)
        keys_u = np.unique(((pow_b[cu] * T + (tr_b[cu] - t0)) * Np
                            + rb_g[cu]))
        gt_u = keys_u // Np
        r_u = keys_u % Np
        rank_u = _group_ranks(gt_u)
        su_bc = int(rank_u.max()) + 1 if len(rank_u) else 1
        cnt_u = np.zeros((G, T), dtype=np.int64)
        if len(keys_u):
            np.add.at(cnt_u, (gt_u // T, gt_u % T), 1)
        off_u = np.zeros((G, T), dtype=np.int64)
        np.cumsum(cnt_u[:-1], axis=0, out=off_u[1:])
        su_btot = max(int(cnt_u.sum(axis=0).max(initial=0)), 1)
        su_rows = np.full((G, T, su_bc), n, dtype=np.int32)
        if len(keys_u):
            su_rows[gt_u // T, gt_u % T, rank_u] = r_u
        # sender side: the row owner fills the slots of every reader
        snd_u = owner[part.col2sup.astype(np.int64)[np.minimum(r_u, n - 1)]] \
            if len(keys_u) else np.zeros(0, dtype=np.int64)
        tt_u = gt_u % T
        skey = snd_u * T + tt_u
        sord = np.lexsort((np.arange(len(keys_u)), skey))
        srank = np.empty(len(keys_u), dtype=np.int64)
        srank[sord] = _group_ranks(skey[sord])
        su_ks = int(srank.max()) + 1 if len(srank) else 1
        su_slot = np.full((G, T, su_ks), su_btot, dtype=np.int32)
        su_srow = np.full((G, T, su_ks), n, dtype=np.int32)
        if len(keys_u):
            gslot = off_u[gt_u // T, tt_u] + rank_u
            su_slot[snd_u, tt_u, srank] = gslot
            su_srow[snd_u, tt_u, srank] = r_u
        solve_cross_slots += len(keys_u)

        # -------- finalize buckets (per device) ------------------------
        fin_buckets = []
        sl_rdst_buckets = []
        for ci in range(ncls):
            c = classes[ci]
            sel = np.nonzero((cls == ci) & (lev >= t0) & (lev < t1))[0]
            if len(sel) == 0:
                continue
            for H in np.unique(hpad[sel]):
                ssel = sel[hpad[sel] == H]
                cnt = np.zeros((G, T), dtype=np.int32)
                np.add.at(cnt, (owner[ssel], lev[ssel] - t0), 1)
                P = int(cnt.max())
                boff = np.zeros((G, T), dtype=np.int32)
                w_t = np.zeros((G, T, P), dtype=np.int32)
                cols0 = np.full((G, T, P), n, dtype=np.int32)
                rows_t = np.full((G, T, P, int(H)), n, dtype=np.int32)
                od = ssel[np.lexsort((ssel, lev[ssel], owner[ssel]))]
                lane_f = _group_ranks(owner[od] * nlev + lev[od])
                gg = owner[od]
                tt = lev[od] - t0
                first = lane_f == 0
                boff[gg[first], tt[first]] = (
                    rowoff[od[first]]
                    - rlo[gg[first], ci, lev[od[first]]])
                w_t[gg, tt, lane_f] = w_all[od]
                cols0[gg, tt, lane_f] = sptr[od]
                ri, ow, intra_r = _expand(rptr[od], h_all[od])
                rows_t[gg[ow], tt[ow], lane_f[ow], intra_r] = rows[ri]
                # lower-solve extended-delta targets: diag rows -> dummy
                # n, local below rows -> global row, cross below rows ->
                # (n+1) + ragged slot
                rdst = np.full((G, T, P, int(H)), n, dtype=np.int32)
                rglob = rows[ri].astype(np.int64)
                below_e = intra_r >= w_all[od[ow]]
                rown_e = owner[part.col2sup.astype(np.int64)[rglob]]
                dval = np.full(len(ri), n, dtype=np.int64)
                loc_e = below_e & (rown_e == gg[ow])
                dval[loc_e] = rglob[loc_e]
                cr_e = below_e & (rown_e != gg[ow])
                if cr_e.any():
                    kq = ((rown_e[cr_e] * T + tt[ow][cr_e]) * Np
                          + rglob[cr_e])
                    pos = np.searchsorted(keys_l, kq)
                    assert np.all(keys_l[pos] == kq), "slot lookup miss"
                    dval[cr_e] = n + 1 + slot_l[pos]
                rdst[gg[ow], tt[ow], lane_f[ow], intra_r] = dval
                sl_rdst_buckets.append(rdst)
                fin_buckets.append(DFinBucket(
                    ccls=ci, c=c, H=int(H), P=P, cnt=cnt, boff=boff,
                    w=w_t, cols0=cols0, rows=rows_t))
                end = boff + (cnt > 0) * P * int(H)
                wslice[ci] = max(wslice[ci], int(end.max()))

        # -------- boundary slots (per class, receiver, step) -----------
        # cross chunks of this segment, keyed by (ci, receiver, level,
        # window row) -> slot = rank of unique row
        brows_cls = []
        bc_cls = []
        slot_keys = []    # per class: sorted unique (g, t, row) keys
        slot_rank = []    # per class: slot index of each key
        if len(cpair):
            seg_sel = np.nonzero(cseg == si)[0]
            crs = seg_sel[cown[seg_sel] != ctown[seg_sel]]
        else:
            seg_sel = np.zeros(0, dtype=np.int64)
            crs = seg_sel
        # boundary rows dedupe to unique (receiver, step, window row).
        # The send buffer is RAGGED over receivers: at step t device g's
        # slots live at [boff[g,t], boff[g,t]+cnt[g,t]) of a btot-row
        # buffer, reduced with ONE psum; each device then applies only
        # its own slice.  (A receiver-padded psum_scatter would move
        # G*max_g(cnt) rows: top-separator steps have a single hot
        # receiver.)
        boff_cls = []
        btot_cls = []
        for ci in range(ncls):
            Wp = np.int64(wslice[ci] + 1)
            if len(crs):
                csel = crs[cc_t[crs] == ci]
                pb = cpair[csel]
                fstart = pr_off[pb] + cpairrow0[csel]
                fr, ow, _ = _expand(fstart, ccnt[csel])
                rloc = dst_win_flat[fr]
                key = ((ctown[csel][ow] * T + (clev[csel][ow] - t0)) * Wp
                       + rloc)
                keys_u = np.unique(key)
            else:
                keys_u = np.zeros(0, dtype=np.int64)
            gt_u = keys_u // Wp
            rank = _group_ranks(gt_u)
            bc = int(rank.max()) + 1 if len(rank) else 0
            cnt_gt = np.zeros((G, T), dtype=np.int64)
            if len(keys_u):
                np.add.at(cnt_gt, (gt_u // T, gt_u % T), 1)
            # ragged offsets: exclusive cumsum over receivers per step
            off_gt = np.zeros((G, T), dtype=np.int64)
            np.cumsum(cnt_gt[:-1], axis=0, out=off_gt[1:])
            btot = int(cnt_gt.sum(axis=0).max(initial=0))
            brow_tab = np.full((G, T, max(bc, 1)), wslice[ci],
                               dtype=np.int32)
            if len(keys_u):
                brow_tab[gt_u // T, gt_u % T, rank] = (keys_u % Wp)
            brows_cls.append(brow_tab)
            bc_cls.append(max(bc, 1))
            boff_cls.append(off_gt.astype(np.int32))
            btot_cls.append(max(btot, 1))
            slot_keys.append(keys_u)
            # global ragged slot of each unique key = off[recv, t] + rank
            slot_rank.append(off_gt[gt_u // T, gt_u % T] + rank
                             if len(keys_u) else rank)
            cross_rows_total += int(len(keys_u))

        # -------- update buckets ---------------------------------------
        upd_buckets = []
        if len(seg_sel):
            for b in np.unique(cbucket[seg_sel]):
                bi = seg_sel[cbucket[seg_sel] == b]
                pb = cpair[bi]
                kcls = int(ck[bi[0]])
                ccls = int(cc_t[bi[0]])
                Mc = int(cmc[bi[0]])
                Q = int(qpad[pb[0]])
                P = int(lane[bi].max()) + 1
                c = classes[ccls]
                Wci = wslice[ccls]
                dummy = Wci + btot_cls[ccls]
                arow = np.zeros((G, T, P), dtype=np.int32)
                brow = np.zeros((G, T, P), dtype=np.int32)
                colq = np.full((G, T, P, Q), c, dtype=np.int32)
                dstt = np.full((G, T, P, Mc), dummy, dtype=np.int32)
                gg = cown[bi]
                tt = clev[bi] - t0
                ll = lane[bi]
                arow[gg, tt, ll] = (astart_pair[pb] - shift[pb] + coff[bi])
                brow[gg, tt, ll] = astart_pair[pb] - shift[pb]
                fstart = pr_off[pb] + cpairrow0[bi]
                fr, ow, intra_c = _expand(fstart, ccnt[bi])
                rloc = dst_win_flat[fr]
                # same-owner -> local window row; cross -> send slot
                cross_m = (cown[bi] != ctown[bi])[ow]
                tg = ctown[bi][ow]
                tt_ow = tt[ow]
                dvals = np.where(cross_m, 0, rloc)
                if cross_m.any():
                    cidx = np.nonzero(cross_m)[0]
                    Wp = np.int64(Wci + 1)
                    kq = (tg[cidx] * T + tt_ow[cidx]) * Wp + rloc[cidx]
                    loc = np.searchsorted(slot_keys[ccls], kq)
                    assert np.all(slot_keys[ccls][loc] == kq)
                    dvals[cidx] = Wci + slot_rank[ccls][loc]
                dstt[gg[ow], tt_ow, ll[ow], col0[bi][ow] + intra_c] = dvals
                br, ow_b, intra_b = _expand(bq_off[pb], qq[pb])
                colq[gg[ow_b], tt[ow_b], ll[ow_b],
                     shift[pb][ow_b] + intra_b] = b_colpos[br]
                upd_buckets.append(DUpdBucket(
                    kcls=kcls, K=classes[kcls], ccls=ccls, c=c, Mc=Mc,
                    Q=Q, arow=arow, brow=brow, colq=colq, dst=dstt))

        rlo_seg = np.ascontiguousarray(
            rlo[:, :, t0:t1].transpose(0, 2, 1)).astype(np.int32)
        for ci in range(ncls):
            over = rlo[:, ci, t0:t1] + wslice[ci] - nrows_dev[:, ci][:, None]
            max_over[ci] = max(max_over[ci], int(over.max(initial=0)))
        segments.append(DSegment(nsteps=T, upd=upd_buckets,
                                 fin=fin_buckets, rlo=rlo_seg,
                                 wslice=tuple(wslice),
                                 bc=tuple(bc_cls), btot=tuple(btot_cls),
                                 brows=brows_cls, boff=boff_cls,
                                 sl_btot=sl_btot, sl_bc=sl_bc,
                                 sl_boff=off_l.astype(np.int32),
                                 sl_rows=sl_rows,
                                 sl_rdst=sl_rdst_buckets,
                                 su_btot=su_btot, su_ks=su_ks,
                                 su_slot=su_slot, su_srow=su_srow,
                                 su_bc=su_bc,
                                 su_boff=off_u.astype(np.int32),
                                 su_rows=su_rows))

    max_mc = max(max(config.chunk_classes), max(config.q_classes))
    nrows = nrows_dev.max(axis=0) + max_over + max_mc + 8 + 1
    nrows = (-(-nrows // 8) * 8).astype(np.int64)

    # fill a_map with the trash row = last row of the padded pool
    for ci in range(ncls):
        per_dev, m, k = a_map[ci]
        trash = (int(nrows[ci]) - 1) * classes[ci]
        for g in range(G):
            idx = per_dev[g]
            m[g, 0, :len(idx)] = aflat[idx]
            m[g, 1, :len(idx)] = idx
            m[g, 0, len(idx):] = trash
            m[g, 1, len(idx):] = 0
        a_map[ci] = m

    cc64 = cc.astype(np.float64)
    flops = float(np.sum(cc64 * cc64))
    total_rows = float(mm.sum()) or 1.0
    comm = {"cross_row_slots": cross_rows_total,
            "solve_cross_slots": int(solve_cross_slots),
            "row_fraction_cross":
                float(mm[owner[dd] != owner[ss]].sum() / total_rows)}
    owner_col = np.concatenate(
        [owner[part.col2sup.astype(np.int64)], [G]]).astype(np.int32)
    layout_meta = dict(part=part, rptr=rptr, rows=rows, cls=cls,
                       wpad=wpad, hpad=hpad, rowoff=rowoff, owner=owner,
                       lev=lev, nnz_l=int(cc.sum()))
    return DistPlan(n=n, G=G, classes=classes, segments=segments,
                    nrows=nrows, a_map=a_map, flops=flops, owner=owner,
                    comm=comm, layout_meta=layout_meta,
                    owner_col=owner_col)
