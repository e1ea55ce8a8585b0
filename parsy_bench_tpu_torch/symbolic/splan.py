"""Supernodal execution plan: the inspector -> batched-executor contract.

Replaces the reference's LBC scheduler (InspectionLevel_06.h:18
``getCoarseLevelSet_6``) with the TPU-native mapping (SURVEY §7C), redesigned
in round 2 around measured TPU primitive rates (scripts/microbench2.py):
data is moved only at **row granularity** (>= 32 lanes) or as contiguous
window slices — element-granular gathers/scatters and XLA's batched
cholesky/triangular_solve are two orders of magnitude too slow.

* Panels live in per-width-class 2-D row pools, level-major and
  height-sorted (symbolic/supernodes.py ``ClassLayout``), so each level's
  targets are one contiguous row window and each finalize bucket is a
  contiguous slice.
* An **update pair** (source panel d -> target s; the reference's
  dsyrk/dgemm pair, parallel_PB_Cholesky_05.h:117-197) is row-chunked; each
  chunk is one lane of a batched MXU einsum C = A @ B~^T where A is the
  chunk's rows (row gather) and B~ is the pair's overlap block gathered
  **pre-aligned to the target's columns** (alignment folded into the index
  table, so C lands column-aligned).  C rows are scatter-added into a
  per-level **delta window** (row-granular scatter) and applied with one
  window subtraction — the conflict-free replacement for ``omp atomic``
  (SURVEY P7).
* **Finalize** (dpotrf + dtrsm, :204-218) is a contiguous window slice per
  (width-class, height-class) bucket, factored by the matmul-only blocked
  Cholesky in ops/dense.py.

Wavefront levels are grouped into ``lax.scan`` segments
(ops/simplicial.py ``segment_levels``), tables padded per segment.

Update pairs exploit the supernodal subset property (the reference's lb/ub
overlap scan, parallel_PB_Cholesky_05.h:137-149): rows of d at or below the
overlap slice all appear in s's row list.

The port's own copy of ``parsy_bench_tpu/symbolic/splan.py`` (the
reference), like the rest of its inspector (``config``, ``core``,
``native``, ``symbolic``): the port imports nothing of the JAX package.
Only the imports differ; ``segment_levels`` comes from
``parsy_bench_tpu_torch/ops/simplicial.py``.  The plan-equality test
(tests/test_torch_supernodal.py) keeps the two emitting the same plan,
field by field, from their own inspectors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from parsy_bench_tpu_torch.core.csc import CSC
from parsy_bench_tpu_torch.config import SolverConfig
from parsy_bench_tpu_torch.ops.simplicial import segment_levels
from parsy_bench_tpu_torch.symbolic.etree import tree_levels
from parsy_bench_tpu_torch.symbolic.supernodes import (
    ClassLayout, build_class_layout, build_partition)


@dataclasses.dataclass
class UpdBucket:
    """Padded batch of update chunks with one tile class per segment.

    Update tables lead with a shard axis G (the w-partition owner axis,
    SURVEY P2; G=1 unsharded), then the step axis T, then lanes P.

    The executor computes, per lane,
        C_hat = A @ B_raw^T            (Mc, Q)  MXU
        C     = C_hat @ S^T            (Mc, c)  MXU, S one-hot from colq
    where A is the chunk's Mc contiguous source rows, B_raw the pair's Q
    contiguous overlap rows, and S the (c, Q) column-alignment selector
    generated on the fly — alignment costs MXU flops instead of gathering
    a dest-width-padded operand (the overlap q is typically << c).
    """
    kcls: int            # source width-class index
    K: int               # source stored width (= classes[kcls])
    ccls: int            # target width-class index
    c: int               # target stored width
    Mc: int              # chunk row count
    Q: int               # padded overlap width (q-class)
    arow: np.ndarray     # (G, T, P) int32 first source row in pool_kcls
    brow: np.ndarray     # (G, T, P) int32 first overlap row in pool_kcls
    colq: np.ndarray     # (G, T, P, Q) int32 target column of each overlap
    #                      row; pad -> c (matches nothing)
    dst: np.ndarray      # (G, T, P, Mc) int32 delta-local target row;
    #                      pad -> the delta dummy row (= wslice[ccls])


@dataclasses.dataclass
class FinBucket:
    """Contiguous window slice of panels with equal (class, height)."""
    ccls: int
    c: int               # stored width
    H: int               # stored height (every panel in the bucket)
    P: int               # padded lane count
    cnt: np.ndarray      # (T,) int32 real lanes per step
    boff: np.ndarray     # (T,) int32 window-local row offset of the slice
    w: np.ndarray        # (T, P) int32 logical width; 0 pad
    h: np.ndarray        # (T, P) int32 logical height (pattern rows); 0 pad
    cols0: np.ndarray    # (T, P) int32 first global column; pad -> n
    rows: np.ndarray     # (T, P, H) int32 global row ids; pad -> n


@dataclasses.dataclass
class SolveUpdBucket:
    """Pair-granular RHS-update batch for the blocked triangular solve.

    One lane per update pair (d -> s): the executor gathers the pair's
    aligned overlap rows of d (``brow``, the factorize B operand), the
    solved x-row of d from the panel-column x/b pool (``xrow``), forms
    y = L_overlap @ x_d and lands it column-aligned on the target
    panel's RHS row (``dst``) — ONE row scatter per pair instead of one
    element per below-diagonal factor row (the ``omp atomic`` scatter of
    the reference trisolve, Triangular_BCSC.h:218)."""
    kcls: int
    K: int
    ccls: int
    c: int
    Q: int
    brow: np.ndarray     # (T, P) int32 aligned overlap start row (pool)
    xrow: np.ndarray     # (T, P) int32 source panel slot (xb pool row)
    colq: np.ndarray     # (T, P, Q) int32 target column; pad -> c
    dst: np.ndarray      # (T, P) int32 window-local target slot; pad ->
    #                      sslice (the delta dummy row)


@dataclasses.dataclass
class TopSolve:
    """Dense trailing-solve block: the thin top levels (root-separator
    panel chains) collapsed into one dense triangular matrix T of ``t``
    columns.  Solves run the leveled scan only over segments
    [0, solve_nseg), apply ALL bottom->top update pairs as a handful of
    single-step batched einsums (``supd``), then finish with one
    Tinv @ rhs GEMV — the MXU-native peeled last level
    (H2LeveledBlockedLsolve_Peeled, Triangular_BCSC.h:238).

    ``gather`` feeds the one-time Tinv preparation: T[dflat] = pool
    entries of every L value among top columns (lower triangle only —
    diag-block strict uppers hold stored inverses, never gathered)."""
    t: int               # dense dimension (total real top columns)
    lev0: int            # first absorbed wavefront level
    #: per class: (3, k) int32 [pool row; pool col; dense flat i*t+j]
    gather: list
    #: per class: (2, k) int32 [xb flat slot position; dense index]
    xmap: list
    #: bottom->top RHS updates, absolute xb-slot dst (pad -> trash row)
    supd: list


@dataclasses.dataclass
class SupSegment:
    nsteps: int
    upd: list[UpdBucket]
    fin: list[FinBucket]
    rlo: np.ndarray      # (ncls, T) int32 window start row per class
    wslice: tuple        # per class: static window slice rows (padded)
    supd: list = dataclasses.field(default_factory=list)
    #                      SolveUpdBucket list (blocked trisolve)
    srlo: np.ndarray | None = None   # (ncls, T) slot window starts
    sslice: tuple | None = None      # per class: static slot window rows
    soff: list = dataclasses.field(default_factory=list)
    #                      per fin bucket: (T,) window-local slot offset
    strue: np.ndarray | None = None  # (ncls, T) true slots per level step
    #: per class: gather/ladder tables replacing the delta scatter-add
    #: (dict(ladder, gidx, pidx)) or None — see _build_gather_tables
    gsc: list | None = None


@dataclasses.dataclass
class SupernodalPlan:
    n: int
    layout: ClassLayout
    lev: np.ndarray      # (nsuper,) supernode level
    nlev: int
    nshards: int
    segments: list[SupSegment]
    flops: float         # true factorization flops
    gemm_flops: float    # padded update-einsum flops (for the cost model)
    nrows: np.ndarray    # (ncls,) final pool rows (incl. slack + dummy row)
    npanels: np.ndarray | None = None  # (ncls,) panel slots per class
    bmap: list | None = None  # per class (2, k): [xb flat pos; b index]
    top: TopSolve | None = None        # dense trailing-solve block
    solve_nseg: int | None = None      # segments the leveled solve scans
    slotw: list | None = None          # per class: (npanels,) slot widths
    gpool_mb: int = 2048               # aligned-operand pool budget
    fin_chol_elems: int = 32 * 2**20   # shared-chol batch cap (elems)

    @property
    def classes(self):
        return self.layout.classes

    def pool_elems(self) -> int:
        return int(sum(int(r) * c
                       for r, c in zip(self.nrows, self.classes)))

    def table_bytes(self) -> int:
        """Total bytes of the emitted device index tables (the HBM cost of
        the schedule, reported per SURVEY §5.5 / VERDICT r1 weak #4)."""
        total = 0
        for seg in self.segments:
            for b in seg.upd:
                total += (b.arow.nbytes + b.brow.nbytes + b.colq.nbytes
                          + b.dst.nbytes)
            for b in seg.fin:
                total += (b.cnt.nbytes + b.boff.nbytes + b.w.nbytes
                          + b.h.nbytes + b.cols0.nbytes + b.rows.nbytes)
            total += seg.rlo.nbytes
        return total


def _cumsum0(x):
    out = np.zeros(len(x) + 1, dtype=np.int64)
    np.cumsum(x, out=out[1:])
    return out


def _expand(starts, counts):
    """Flat [starts[i] + 0..counts[i]) for every i (vectorized ragged
    arange); also returns the owner index per element."""
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    owner = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    off = _cumsum0(counts)
    intra = np.arange(total, dtype=np.int64) - off[owner]
    return np.asarray(starts, dtype=np.int64)[owner] + intra, owner, intra


def emit_pairs(rptr, rows, sptr, col2sup):
    """All update pairs (d, s, lb, q) from the supernodal row patterns
    (vectorized).  lb = first row index (within d's pattern) of the run of
    rows mapping to supernode s; q = run length (overlap width)."""
    nsuper = len(rptr) - 1
    widths = np.diff(sptr)
    h = np.diff(rptr)
    # below-diagonal rows of every panel, flat
    below_idx, d_of, intra = _expand(rptr[:-1] + widths, h - widths)
    tgt = col2sup[rows[below_idx]].astype(np.int64)
    # run starts: first element per panel or target change
    first = np.zeros(len(tgt), dtype=bool)
    if len(tgt):
        first[0] = True
        first[1:] = (d_of[1:] != d_of[:-1]) | (tgt[1:] != tgt[:-1])
    starts = np.nonzero(first)[0]
    ends = np.concatenate([starts[1:], [len(tgt)]])
    dd = d_of[starts]
    ss = tgt[starts]
    lb = widths[dd] + intra[starts]
    qq = ends - starts
    return dd, ss, lb, qq


def _build_gather_tables(upd_buckets, wslice, T, ncls):
    """Static gather/ladder tables that turn the per-step delta
    SCATTER-add into pure gathers + dense sums (scatter-free updates).

    The executor's ``deltas.at[dst].add(C)`` scatters one row per padded
    chunk row (5.3M at n=1e5), while a static ``take`` moves rows without
    atomics; the card's factorize times in both modes are in PERF.md §5.
    Every (chunk row -> window row) assignment is known at inspection
    time, so the scatter inverts statically:

    * all real chunk rows of a step's C buffers (concatenated per target
      class, one leading zero row) are grouped by target window row;
    * each window row's contribution count is padded to a power-of-two
      LADDER class m; ``gidx[m]`` is (T, R_m, m) source positions (+1;
      0 = the zero row) — the executor gathers and sums axis 1;
    * ``pidx`` (T, wslice) maps every window row to its summed group in
      the step's stacked [zero | ladder-class sums] buffer (untouched
      rows -> 0), so the delta lands as ONE dense take + subtract.

    Only padded-lane/alignment-row entries are dropped (they are never
    referenced), which also skips the ~35% of scattered rows that were
    pure chunk padding.  Reference analog: the column-major assembly of
    updates the scatter replaced (parallel_PB_Cholesky_05.h:160-197) —
    same sums, different (static) order.
    """
    out = []
    for ci in range(ncls):
        bks = [b for b in upd_buckets if b.ccls == ci]
        if not bks:
            out.append(None)
            continue
        ts_l, wr_l, fp_l = [], [], []
        base = 0
        for b in bks:
            G, Tb, P, Mc = b.dst.shape
            assert G == 1, "gather tables are single-shard only"
            d = b.dst[0]
            tt, pp, mm = np.nonzero(d != wslice[ci])
            ts_l.append(tt)
            wr_l.append(d[tt, pp, mm])
            fp_l.append(base + pp * np.int64(Mc) + mm)
            base += P * Mc
        ts = np.concatenate(ts_l).astype(np.int64)
        wr = np.concatenate(wr_l).astype(np.int64)
        fp = np.concatenate(fp_l).astype(np.int64)
        if not len(ts):
            out.append(None)
            continue
        key = ts * np.int64(wslice[ci] + 1) + wr
        order = np.lexsort((fp, key))
        key_s, fp_s = key[order], fp[order]
        first = np.ones(len(key_s), dtype=bool)
        first[1:] = key_s[1:] != key_s[:-1]
        gstart = np.nonzero(first)[0]
        gcnt = np.diff(np.concatenate([gstart, [len(key_s)]]))
        g_t = key_s[gstart] // np.int64(wslice[ci] + 1)
        g_w = key_s[gstart] % np.int64(wslice[ci] + 1)
        ladder = [1]
        while ladder[-1] < int(gcnt.max()):
            ladder.append(ladder[-1] * 2)
        mcls = np.searchsorted(ladder, gcnt)
        pidx = np.zeros((T, wslice[ci]), dtype=np.int32)
        gidx, lad_used = [], []
        stack_off = 1                       # 0 = the zero row
        for li in np.unique(mcls):
            m = int(ladder[li])
            sel = np.nonzero(mcls == li)[0]
            sel = sel[np.lexsort((sel, g_t[sel]))]
            rank = _group_ranks(g_t[sel])
            R = int(rank.max()) + 1
            gi = np.zeros((T, R, m), dtype=np.int32)
            rs, ow, intra = _expand(gstart[sel], gcnt[sel])
            gi[g_t[sel][ow], rank[ow], intra] = (fp_s[rs] + 1).astype(
                np.int32)
            pidx[g_t[sel], g_w[sel]] = (stack_off + rank).astype(np.int32)
            stack_off += R
            gidx.append(gi)
            lad_used.append(m)
        out.append(dict(ladder=tuple(lad_used), gidx=gidx, pidx=pidx,
                        ntot=base))
    return out


def _chunk_pairs(m, chunk_classes):
    """Greedy split of each pair's m rows into descending chunk classes.
    Returns (pair_of_chunk, mc_class, off, mtrue) flat arrays."""
    m = np.asarray(m, dtype=np.int64)
    npairs = len(m)
    parts = []
    base = np.zeros(npairs, dtype=np.int64)
    rem = m.copy()
    for i, ch in enumerate(chunk_classes):
        cnt = rem // ch if i < len(chunk_classes) - 1 else -(-rem // ch)
        starts, owner, intra = _expand(base, cnt)
        off = base[owner] + intra * ch
        mtrue = np.minimum(ch, m[owner] - off)
        parts.append((owner, np.full(len(owner), ch, dtype=np.int64),
                      off, mtrue))
        base = base + cnt * ch
        rem = np.maximum(m - base, 0)
    owner = np.concatenate([p[0] for p in parts])
    mcc = np.concatenate([p[1] for p in parts])
    off = np.concatenate([p[2] for p in parts])
    mtrue = np.concatenate([p[3] for p in parts])
    return owner, mcc, off, mtrue


def _group_ranks(keys_sorted):
    """Rank within equal-key runs of an already-sorted key array."""
    n = len(keys_sorted)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    newgrp = np.ones(n, dtype=bool)
    newgrp[1:] = keys_sorted[1:] != keys_sorted[:-1]
    gid = np.cumsum(newgrp) - 1
    gstart = _cumsum0(np.bincount(gid))[gid]
    return np.arange(n, dtype=np.int64) - gstart


def _shard_of(cost, group_key, nshards):
    """Worst-fit-decreasing assignment of chunks to shards within each
    group (the reference's worstFitBinPack, common/TreeUtils.h:217).
    Vectorized approximation: sort by cost descending within group and
    deal round-robin — equivalent to WFD when costs are similar, and
    cost-balanced because heavy chunks spread first."""
    if nshards <= 1:
        return np.zeros(len(cost), dtype=np.int64)
    order = np.lexsort((-cost, group_key))
    rank = _group_ranks(group_key[order])
    g = np.empty(len(cost), dtype=np.int64)
    g[order] = rank % nshards
    return g


def slack_levels(part, rptr: np.ndarray, rows: np.ndarray,
                 lev: np.ndarray, classes, height_unit: int = 8,
                 max_shift: int = 64) -> np.ndarray:
    """Slack-based level placement: delay supernodes from their earliest
    wavefront level into later levels to flatten each (width-class,
    height-class) bucket's per-level lane histogram — fewer padded lanes
    per scan step (the reference exploits the same slack
    height-depth-level freedom, InspectionLevel_06.h:118-132 +
    makeSlackedLevelSet, TreeUtils.h:415).

    Validity: supernode d must finalize strictly before every supernode
    it updates (its ancestors holding its below-diagonal rows), i.e.
    new_lev[d] < min(new_lev[targets(d)]).  Processing in decreasing
    earliest-level order guarantees every target is already placed.
    Ties pick the earliest level, so a balanced plan never gets deeper.
    """
    from parsy_bench_tpu_torch.symbolic.supernodes import _height_class
    nsuper = part.nsuper
    if nsuper == 0:
        return lev
    nlev = int(lev.max(initial=-1)) + 1
    w = np.diff(part.sptr)
    h = np.diff(rptr)
    cls = np.searchsorted(np.asarray(classes), w)
    wpad = np.asarray(classes)[np.minimum(cls, len(classes) - 1)]
    hpad = _height_class(h, wpad)
    # bucket key per supernode
    key_raw = cls.astype(np.int64) * (int(hpad.max()) + 1) + hpad
    _, key = np.unique(key_raw, return_inverse=True)
    nkey = int(key.max()) + 1

    # targets per supernode (unique ancestor supernodes of below rows)
    dd, ss, _, _ = emit_pairs(rptr, rows, part.sptr, part.col2sup)
    pord = np.argsort(dd, kind="stable")
    pptr = _cumsum0(np.bincount(dd[pord], minlength=nsuper))
    pss = ss[pord]

    # current per-(key, level) lane counts at the earliest placement
    load = np.zeros((nkey, nlev), dtype=np.int64)
    np.add.at(load, (key, lev), 1)
    assigned = lev.astype(np.int64).copy()
    order = np.argsort(-lev, kind="stable")
    for s in order:
        e = int(lev[s])
        tgt = pss[pptr[s]:pptr[s + 1]]
        lat = int(assigned[tgt].min()) - 1 if len(tgt) else nlev - 1
        lat = min(lat, e + max_shift)
        if lat <= e:
            continue
        k = key[s]
        window = load[k, e + 1:lat + 1]
        # peak-shave: move only into a level where this bucket already
        # has lanes (never seeds a new (bucket, level) pair — that would
        # add whole padded bucket blocks to new scan segments), and only
        # when it strictly flattens the histogram
        cand = np.nonzero(window > 0)[0]
        if len(cand) == 0:
            continue
        t = e + 1 + int(cand[np.argmin(window[cand])])
        if load[k, t] + 1 < load[k, e]:
            assigned[s] = t
            load[k, t] += 1
            load[k, e] -= 1
    return assigned


def build_supernodal_plan(a: CSC, parent: np.ndarray, cc: np.ndarray,
                          lpat: sp.csc_matrix | None = None,
                          config: SolverConfig | None = None
                          ) -> SupernodalPlan:
    """Inspector: partition -> class layout -> batched step tables.

    ``lpat`` may be None: the layout then takes its row patterns from the
    native etree walk and the simplicial pattern stays lazy (verification
    only) — the all-native analyze contract (reference LSparsity.h:256)."""
    config = config or SolverConfig()
    part = build_partition(a, parent, cc, config.nrelax, config.zrelax,
                           config.max_supernode_width)
    lev = tree_levels(part.sparent)
    from parsy_bench_tpu_torch.symbolic.supernodes import (
        _native, supernodal_rows, supernodal_rows_from_etree)
    if lpat is None and _native is not None \
            and hasattr(_native, "supernodal_rows"):
        rptr, rows = supernodal_rows_from_etree(a, parent, part)
    else:
        if lpat is None:
            from parsy_bench_tpu_torch.symbolic.colcounts import (
                symbolic_pattern)
            lpat = symbolic_pattern(a, parent)
        rptr, rows = supernodal_rows(lpat, part)
    if config.slack_placement:
        lev = slack_levels(part, rptr, rows, lev, config.width_classes)
    layout = build_class_layout(lpat, a, part, lev, config.width_classes,
                                parent=parent, nnz_l=int(cc.sum()),
                                rptr=rptr, rows=rows)
    return plan_from_layout(a.n, layout, cc=cc, config=config)


def plan_from_layout(n: int, layout: ClassLayout, cc=None,
                     config: SolverConfig | None = None,
                     with_updates: bool = True) -> SupernodalPlan:
    """Emit the executor tables for a laid-out factor.  ``with_updates``
    False emits a finalize/solve-only plan (blocked trisolve on a given
    numeric L, reference Triangular_BCSC.h:171)."""
    config = config or SolverConfig()
    part = layout.part
    lev, nlev = layout.lev, int(layout.lev.max(initial=-1)) + 1
    G = max(1, int(config.num_partitions))
    sptr = part.sptr
    rptr, rows = layout.rptr, layout.rows
    rowoff, cls, wpad, hpad = (layout.rowoff, layout.cls, layout.wpad,
                               layout.hpad)
    classes = layout.classes
    ncls = len(classes)
    h_all = np.diff(rptr)
    w_all = np.diff(sptr)
    gemm_flops = 0.0

    # ----------------------------------------------------------- pairs
    # Pair arrays feed BOTH the factorize update chunks (with_updates)
    # and the pair-granular solve-update tables (always emitted — the
    # blocked trisolve of a given factor needs them too).
    if True:
        dd, ss, lb, qq = emit_pairs(rptr, rows, sptr, part.col2sup)
        mm = (rptr[dd + 1] - rptr[dd] - lb).astype(np.int64)
        ridx, pair_of, intra = _expand(rptr[dd] + lb, mm)
        rv = rows[ridx].astype(np.int64)
        if with_updates:
            # per-pair-row target positions (vectorized searchsorted);
            # needs the supernodal subset property, which only CHORDAL
            # factors guarantee — solve-only plans (non-chordal L) skip it
            sup_of_row = np.repeat(np.arange(part.nsuper, dtype=np.int64),
                                   h_all)
            row_keys = sup_of_row * np.int64(n + 1) + rows.astype(np.int64)
            pos = np.searchsorted(row_keys,
                                  ss[pair_of] * np.int64(n + 1) + rv)
            assert np.all(rows[pos] == rv), "supernodal subset violated"
            # delta-window-local target row of every pair row
            dst_local_flat = (rowoff[ss[pair_of]]
                              + (pos - rptr[ss[pair_of]])
                              - layout.rlo[cls[ss[pair_of]],
                                           lev[ss[pair_of]]]
                              ).astype(np.int64)
        pr_off = _cumsum0(mm)          # pair -> flat row range
        # overlap columns: first q rows of each pair -> target column pos
        bsel = intra < qq[pair_of]
        b_colpos = (rv[bsel] - sptr[ss[pair_of[bsel]]]).astype(np.int64)
        bq_off = _cumsum0(qq)          # pair -> flat colpos range
        # --- 8-row alignment (packed gathers) ------------------------
        # Chunk/operand starts are floored to multiples of PACK so the
        # executor can gather PACK-row-fat packed rows at stream-class
        # rates (index-driven gathers cost per ROW, scripts/microbench6);
        # the up-to-PACK-1 pre-rows per pair are masked via dst dummies /
        # no-match colq entries.
        PACK = 8
        astart_pair = rowoff[dd] + lb            # first tail row (pool)
        shift = astart_pair % PACK               # per-pair misalignment
        m_eff = mm + shift
        qq_eff = qq + shift
        # q-classes (padded aligned overlap widths)
        qcls_ladder = np.asarray(config.q_classes)
        if np.any(qcls_ladder % PACK):
            raise ValueError("q_classes must be multiples of 8")
        if len(qq) and qcls_ladder[-1] < qq_eff.max():
            raise ValueError(
                f"q_classes must cover the widest aligned overlap "
                f"({qq_eff.max(initial=0)})")
        q_idx = np.searchsorted(qcls_ladder, qq_eff)
        qpad = qcls_ladder[q_idx]
        # chunks over the shifted row ranges; boundaries stay aligned
        # because chunk classes are multiples of PACK
        if np.any(np.asarray(config.chunk_classes) % PACK):
            raise ValueError("chunk_classes must be multiples of 8")
    if with_updates:
        cpair, cmc, coff, cmtrue_eff = _chunk_pairs(
            m_eff, config.chunk_classes)
        col0 = np.where(coff == 0, shift[cpair], 0)   # first real column
        ccnt = cmtrue_eff - col0                      # real rows in chunk
        cpairrow0 = coff + col0 - shift[cpair]        # first pair row
        ck = cls[dd[cpair]]
        cc_t = cls[ss[cpair]]
        clev = lev[ss[cpair]]
        # bucket id: (kcls, ccls, mc-class, q-class)
        mc_idx = np.searchsorted(-np.asarray(config.chunk_classes), -cmc)
        nq = len(config.q_classes)
        cbucket = (((ck * ncls + cc_t) * len(config.chunk_classes)
                    + mc_idx) * nq + q_idx[cpair])
        nbuckets = ncls * ncls * len(config.chunk_classes) * nq
    else:
        cpair = np.zeros(0, dtype=np.int64)

    # ------------------------------------------------- level statistics
    # per-level lane counts PER BUCKET KEY: segments pad each bucket's
    # lane axis to the segment max, so segmentation must see the exact
    # quantities that get padded (the LBC coarsening trade-off: fewer
    # scans vs padded lanes; reference getCoarseLevelSet_6's cost vs
    # parallelism balance, InspectionLevel_06.h:18)
    fin_cnt_cls = np.zeros((ncls, nlev), dtype=np.int64)
    for ci in range(ncls):
        np.add.at(fin_cnt_cls[ci], lev[cls == ci], 1)
    if len(cpair):
        bcnt = np.zeros((nlev, nbuckets), dtype=np.float64)
        lane_cost = (cmc * (wpad[dd[cpair]] + wpad[ss[cpair]])
                     ).astype(np.float64) / 64.0
        np.add.at(bcnt, (clev, cbucket), lane_cost)
    else:
        bcnt = np.zeros((nlev, 0), dtype=np.float64)
    wr = layout.wrows.astype(np.float64)
    stats = np.concatenate([bcnt, fin_cnt_cls.T, wr.T / 64.0], axis=1)
    segs = segment_levels(stats, alpha=float(config.segment_alpha),
                          slack=4.0) if nlev else []

    # --------------------------------------------- per-segment emission
    dummy_row = [int(layout.nrows[ci]) for ci in range(ncls)]  # set later
    segments: list[SupSegment] = []
    max_over = np.zeros(ncls, dtype=np.int64)   # pool slack requirement

    # panel-slot coordinates for the blocked trisolve (pair-granular RHS
    # updates into a panel-column x/b pool — see SolveUpdBucket): slot of
    # a panel = its rank in the class pool order; slot windows mirror the
    # row windows
    pslot = np.zeros(part.nsuper, dtype=np.int64)
    slot_rlo = np.zeros((ncls, nlev), dtype=np.int64)
    npanels = np.zeros(ncls, dtype=np.int64)
    for ci in range(ncls):
        sel = np.nonzero(cls == ci)[0]
        order = sel[np.lexsort((sel, hpad[sel], lev[sel]))]
        pslot[order] = np.arange(len(order))
        npanels[ci] = len(order)
        pc = np.zeros(nlev, dtype=np.int64)
        np.add.at(pc, lev[sel], 1)
        slot_rlo[ci] = _cumsum0(pc)[:-1]
    max_sover = np.zeros(ncls, dtype=np.int64)  # xb pool slack

    seg_of_lev = np.zeros(nlev, dtype=np.int64)
    for si, (t0, t1) in enumerate(segs):
        seg_of_lev[t0:t1] = si

    # ---------------- dense-top selection (solve side only) ------------
    # absorb trailing segments while their levels are thin and the total
    # column count fits the Tinv budget; solves then scan only segments
    # [0, s0) and finish with one dense GEMV (TopSolve docstring)
    s0 = len(segs)
    if config.dense_top_cols > 0 and nlev > 0:
        lev_pan = np.bincount(lev, minlength=nlev)
        lev_w = np.zeros(nlev, dtype=np.int64)
        np.add.at(lev_w, lev, w_all)
        cum = 0
        for si in range(len(segs) - 1, -1, -1):
            t0s, t1s = segs[si]
            if lev_pan[t0s:t1s].max(initial=0) > config.dense_top_thin:
                break
            segcols = int(lev_w[t0s:t1s].sum())
            if cum + segcols > config.dense_top_cols:
                break
            cum += segcols
            s0 = si
        if s0 == len(segs) or nlev - segs[s0][0] < 4:
            s0 = len(segs)          # not worth a dense block
    lev0 = segs[s0][0] if s0 < len(segs) else nlev

    if with_updates and len(cpair):
        cseg = seg_of_lev[clev]
        # global sort of chunks by (segment, bucket, shard, level) and
        # lane ranks within (segment, bucket, shard, level)
        cost = (cmc * wpad[dd[cpair]] * wpad[ss[cpair]]).astype(np.float64)
        gkey = ((cseg * nbuckets + cbucket) * nlev + clev)
        gshard = _shard_of(cost, gkey, G)
        skey = (gkey * G + gshard)
        order = np.lexsort((np.arange(len(cpair)), skey))
        lane = np.empty(len(cpair), dtype=np.int64)
        lane[order] = _group_ranks(skey[order])

    for si, (t0, t1) in enumerate(segs):
        T = t1 - t0
        rlo_seg = layout.rlo[:, t0:t1].astype(np.int32)
        wtrue_seg = layout.wrows[:, t0:t1]
        wslice = [int(wtrue_seg[ci].max(initial=0)) for ci in range(ncls)]

        # ---------------- finalize buckets (contiguous slices) ----------
        fin_buckets: list[FinBucket] = []
        soff_buckets: list[np.ndarray] = []
        Pmax = np.zeros(ncls, dtype=np.int64)
        for ci in range(ncls):
            c = classes[ci]
            sel = np.nonzero((cls == ci) & (lev >= t0) & (lev < t1))[0]
            if len(sel) == 0:
                continue
            # pool order within a level is (hpad, id) — recover buckets
            for H in np.unique(hpad[sel]):
                ss_h = sel[hpad[sel] == H]
                cnt = np.zeros(T, dtype=np.int32)
                np.add.at(cnt, lev[ss_h] - t0, 1)
                # lane axis padded to a multiple of the shard count so the
                # sharded executor can stride-partition bucket ownership;
                # single-shard SMALL-H buckets pad to 64 so the fused
                # finalize Pallas kernel gets its best lane tile (the
                # padding costs <= 63*H*c pool elems — cheap at H <= 128,
                # but 63*4096*128 elems on a tall bucket, measured +42%
                # total pool at n=1e5 when applied indiscriminately);
                # tall buckets stay unpadded and the kernel drops to the
                # largest power-of-two divisor of P (>= 1 always works)
                Pmul = 64 if (G == 1 and int(H) <= 128) else G
                P = -(-int(cnt.max()) // Pmul) * Pmul
                Pmax[ci] = max(Pmax[ci], P)
                boff = np.zeros(T, dtype=np.int32)
                soff = np.zeros(T, dtype=np.int32)
                w_t = np.zeros((T, P), dtype=np.int32)
                h_t = np.zeros((T, P), dtype=np.int32)
                cols0 = np.full((T, P), n, dtype=np.int32)
                rows_t = np.full((T, P, int(H)), n, dtype=np.int32)
                od = ss_h[np.lexsort((ss_h, lev[ss_h]))]
                lane_f = _group_ranks(lev[od])
                tt = lev[od] - t0
                first = lane_f == 0
                boff[tt[first]] = (rowoff[od[first]]
                                   - layout.rlo[ci, lev[od[first]]])
                soff[tt[first]] = (pslot[od[first]]
                                   - slot_rlo[ci, lev[od[first]]])
                w_t[tt, lane_f] = w_all[od]
                h_t[tt, lane_f] = h_all[od]
                cols0[tt, lane_f] = sptr[od]
                ri, owner, intra_r = _expand(rptr[od], h_all[od])
                rows_t[tt[owner], lane_f[owner], intra_r] = rows[ri]
                # split giant buckets along the lane axis: the executor
                # materializes several (P, H, c) temps per bucket, and at
                # n=1e6 the 252k-lane leaf bucket's temps are 3.9 GB
                # each (4x tiling expansion at c=32) — the factorize
                # program exceeded HBM by 461 MB.  A level's lanes are
                # contiguous in the pool from boff, so chunk k is the
                # same bucket with boff shifted by k*cap*H.
                cap = max(Pmul, (int(config.fin_bucket_elems)
                                 // (int(H) * c)) // Pmul * Pmul)
                for k0 in range(0, P, cap):
                    k1 = min(k0 + cap, P)
                    fin_buckets.append(FinBucket(
                        ccls=ci, c=c, H=int(H), P=k1 - k0,
                        cnt=np.clip(cnt - k0, 0, k1 - k0).astype(
                            np.int32),
                        boff=(boff + k0 * int(H)).astype(np.int32),
                        w=w_t[:, k0:k1], h=h_t[:, k0:k1],
                        cols0=cols0[:, k0:k1], rows=rows_t[:, k0:k1]))
                    # slots mirror pool order, so chunk k's slot offset
                    # shifts by its lane offset
                    soff_buckets.append((soff + k0).astype(np.int32))
                end = boff + P * int(H)
                wslice[ci] = max(wslice[ci], int(end.max()))

        # ---------------- update buckets --------------------------------
        upd_buckets: list[UpdBucket] = []
        if with_updates and len(cpair):
            seg_sel = np.nonzero(cseg == si)[0]
            for b in np.unique(cbucket[seg_sel]):
                bi = seg_sel[cbucket[seg_sel] == b]
                pb = cpair[bi]
                kcls = int(ck[bi[0]])
                ccls = int(cc_t[bi[0]])
                Mc = int(cmc[bi[0]])
                Q = int(qpad[pb[0]])
                K = classes[kcls]
                c = classes[ccls]
                P = int(lane[bi].max()) + 1
                arow = np.zeros((G, T, P), dtype=np.int32)
                brow = np.zeros((G, T, P), dtype=np.int32)
                colq = np.full((G, T, P, Q), c, dtype=np.int32)
                dstt = np.full((G, T, P, Mc), wslice[ccls] + 0,
                               dtype=np.int32)
                gg = gshard[bi]
                tt = clev[bi] - t0
                ll = lane[bi]
                # aligned chunk/operand starts (multiples of PACK)
                arow[gg, tt, ll] = (astart_pair[pb] - shift[pb]
                                    + coff[bi])
                brow[gg, tt, ll] = astart_pair[pb] - shift[pb]
                # dst rows: the chunk's real rows start at column col0
                # (pre-rows from alignment stay at the dummy row)
                fstart = pr_off[pb] + cpairrow0[bi]
                fr, owner, intra_c = _expand(fstart, ccnt[bi])
                dstt[gg[owner], tt[owner], ll[owner],
                     col0[bi][owner] + intra_c] = dst_local_flat[fr]
                # overlap target columns at q-positions shift..shift+q
                br, owner_b, intra_b = _expand(bq_off[pb], qq[pb])
                colq[gg[owner_b], tt[owner_b], ll[owner_b],
                     shift[pb][owner_b] + intra_b] = b_colpos[br]
                # split giant buckets along the lane axis: one bucket's
                # gathered A slab is (P*Mc, K) and at n=1e6 a single
                # 256-chunk bucket materialized 3.75 GB (HBM OOM); the
                # cap keeps each slab <= ~128 MB and is never reached at
                # n <= 3e5
                pcap = max(1, int(config.fin_bucket_elems) // (Mc * K))
                for k0 in range(0, P, pcap):
                    k1 = min(k0 + pcap, P)
                    upd_buckets.append(UpdBucket(
                        kcls=kcls, K=K, ccls=ccls, c=c, Mc=Mc, Q=Q,
                        arow=arow[:, :, k0:k1], brow=brow[:, :, k0:k1],
                        colq=colq[:, :, k0:k1], dst=dstt[:, :, k0:k1]))

        # ------------- solve-update buckets (pair granular) -------------
        # the slot window is over-allocated by the largest bucket P so
        # per-bucket RHS slices at soff never clamp; writes are masked
        strue = np.zeros((ncls, T), dtype=np.int64)
        for ci in range(ncls):
            nxt = np.concatenate([slot_rlo[ci, t0 + 1:t1],
                                  [npanels[ci] if t1 >= nlev
                                   else slot_rlo[ci, t1]]])
            strue[ci] = nxt - slot_rlo[ci, t0:t1]
        sslice = tuple(int(strue[ci].max(initial=0) + Pmax[ci])
                       for ci in range(ncls))
        supd_buckets: list[SolveUpdBucket] = []
        if len(dd) and si < s0:
            psel = np.nonzero(seg_of_lev[lev[ss]] == si)[0]  # pairs by tgt
            if len(psel):
                pq = q_idx[psel]
                pbkey = (cls[dd[psel]] * ncls + cls[ss[psel]]) \
                    * len(config.q_classes) + pq
                plkey = pbkey * nlev + lev[ss[psel]]
                pord = np.lexsort((psel, plkey))
                plane = np.empty(len(psel), dtype=np.int64)
                plane[pord] = _group_ranks(plkey[pord])
                for bk in np.unique(pbkey):
                    bi = psel[pbkey == bk]
                    kcls = int(cls[dd[bi[0]]])
                    ccls = int(cls[ss[bi[0]]])
                    Q = int(qpad[bi[0]])
                    c = classes[ccls]
                    P = int(plane[pbkey == bk].max()) + 1
                    browt = np.zeros((T, P), dtype=np.int32)
                    # xrow pad 0 is harmless: padded lanes carry colq=c
                    # (no column match) and dst=dummy
                    xrowt = np.zeros((T, P), dtype=np.int32)
                    colqt = np.full((T, P, Q), c, dtype=np.int32)
                    dstt = np.full((T, P), sslice[ccls], dtype=np.int32)
                    tt = lev[ss[bi]] - t0
                    ll = plane[pbkey == bk]
                    browt[tt, ll] = astart_pair[bi] - shift[bi]
                    xrowt[tt, ll] = pslot[dd[bi]]
                    dstt[tt, ll] = (pslot[ss[bi]]
                                    - slot_rlo[ccls, lev[ss[bi]]])
                    br, ow_b, intra_b = _expand(bq_off[bi], qq[bi])
                    colqt[tt[ow_b], ll[ow_b],
                          shift[bi][ow_b] + intra_b] = b_colpos[br]
                    supd_buckets.append(SolveUpdBucket(
                        kcls=kcls, K=classes[kcls], ccls=ccls, c=c, Q=Q,
                        brow=browt, xrow=xrowt, colq=colqt, dst=dstt))

        for ci in range(ncls):
            over = rlo_seg[ci].astype(np.int64) + wslice[ci] \
                - layout.nrows[ci]
            max_over[ci] = max(max_over[ci], int(over.max(initial=0)))
            sover = slot_rlo[ci, t0:t1] + sslice[ci] - npanels[ci]
            max_sover[ci] = max(max_sover[ci], int(sover.max(initial=0)))
        gsc = None
        if (with_updates and upd_buckets and G == 1
                and getattr(config, "update_delta", "gather") == "gather"):
            gsc = _build_gather_tables(upd_buckets, wslice, T, ncls)
        segments.append(SupSegment(nsteps=T, upd=upd_buckets,
                                   fin=fin_buckets, rlo=rlo_seg,
                                   wslice=tuple(wslice),
                                   supd=supd_buckets,
                                   srlo=slot_rlo[:, t0:t1].astype(np.int32),
                                   sslice=sslice, soff=soff_buckets,
                                   strue=strue.astype(np.int32),
                                   gsc=gsc))

    # pool slack so every window slice and padded gather is in-bounds;
    # rounded to a multiple of 8 so pools reshape to packed (r/8, 8c)
    # form for the fat-row gathers
    max_mc = max(max(config.chunk_classes), max(config.q_classes)) \
        if with_updates else 0
    nrows = layout.nrows + max_over + max_mc + 8 + 1
    nrows = (-(-nrows // 8) * 8).astype(np.int64)

    # xb-pool sizing + b<->panel-column maps for the blocked trisolve
    npanels_pad = npanels + max_sover + 1
    slotw = []
    for ci in range(ncls):
        wv = np.zeros(int(npanels_pad[ci]), dtype=np.int32)
        selw = np.nonzero(cls == ci)[0]
        wv[pslot[selw]] = w_all[selw]
        slotw.append(wv)
    bmap = []
    cols = np.arange(n, dtype=np.int64)
    s_of_col = part.col2sup.astype(np.int64)
    bflat = (pslot[s_of_col] * np.asarray(classes)[cls[s_of_col]]
             + (cols - sptr[s_of_col]))
    for ci in range(ncls):
        m = cls[s_of_col] == ci
        bmap.append(np.stack([bflat[m], cols[m]]))

    # ---------------- dense-top table emission -------------------------
    top = None
    if s0 < len(segs):
        tsel = np.nonzero(lev >= lev0)[0]
        tsel = tsel[np.argsort(sptr[tsel])]     # ascending columns
        tw = w_all[tsel].astype(np.int64)
        t = int(tw.sum())
        tcols, _, _ = _expand(sptr[tsel], tw)   # sorted global columns
        # T gather: all (row, col) pattern entries with row >= col
        cnt_e = h_all[tsel] * tw
        _, pan_of, intra_e = _expand(np.zeros(len(tsel), dtype=np.int64),
                                     cnt_e)
        a_r = intra_e // tw[pan_of]
        b_c = intra_e % tw[pan_of]
        sg = tsel[pan_of]
        gi = rows[rptr[sg] + a_r].astype(np.int64)
        gj = (sptr[sg] + b_c).astype(np.int64)
        keep = gi >= gj
        sg, a_r, b_c, gi, gj = (x[keep] for x in (sg, a_r, b_c, gi, gj))
        di = np.searchsorted(tcols, gi)
        dj = np.searchsorted(tcols, gj)
        assert np.all(tcols[di] == gi), "top rows escape top columns"
        prow = rowoff[sg] + a_r                 # pool row (class-local)
        gather = []
        for ci in range(ncls):
            m = cls[sg] == ci
            gather.append(np.stack([prow[m], b_c[m],
                                    di[m] * np.int64(t) + dj[m]]))
        # x/rhs map: xb slot positions of every top column
        xs_g = tsel[np.repeat(np.arange(len(tsel)), tw)]
        xj = tcols - sptr[xs_g]
        xpos = pslot[xs_g] * np.asarray(classes)[cls[xs_g]] + xj
        dix = np.arange(t, dtype=np.int64)
        xmap = []
        for ci in range(ncls):
            m = cls[xs_g] == ci
            xmap.append(np.stack([xpos[m], dix[m]]))
        # bottom->top update pairs as single-step buckets
        top_supd: list[SolveUpdBucket] = []
        if len(dd):
            psel = np.nonzero((lev[ss] >= lev0) & (lev[dd] < lev0))[0]
            if len(psel):
                pq = q_idx[psel]
                pbkey = (cls[dd[psel]] * ncls + cls[ss[psel]]) \
                    * len(config.q_classes) + pq
                pord = np.lexsort((psel, pbkey))
                plane = np.empty(len(psel), dtype=np.int64)
                plane[pord] = _group_ranks(pbkey[pord])
                for bk in np.unique(pbkey):
                    sel_b = pbkey == bk
                    bi = psel[sel_b]
                    kcls = int(cls[dd[bi[0]]])
                    ccls = int(cls[ss[bi[0]]])
                    Q = int(qpad[bi[0]])
                    c = classes[ccls]
                    P = int(plane[sel_b].max()) + 1
                    trash = int(npanels_pad[ccls]) - 1
                    browt = np.zeros((1, P), dtype=np.int32)
                    xrowt = np.zeros((1, P), dtype=np.int32)
                    colqt = np.full((1, P, Q), c, dtype=np.int32)
                    dstt = np.full((1, P), trash, dtype=np.int32)
                    ll = plane[sel_b]
                    browt[0, ll] = astart_pair[bi] - shift[bi]
                    xrowt[0, ll] = pslot[dd[bi]]
                    dstt[0, ll] = pslot[ss[bi]]
                    br, ow_b, intra_b = _expand(bq_off[bi], qq[bi])
                    colqt[0, ll[ow_b],
                          shift[bi][ow_b] + intra_b] = b_colpos[br]
                    top_supd.append(SolveUpdBucket(
                        kcls=kcls, K=classes[kcls], ccls=ccls, c=c, Q=Q,
                        brow=browt, xrow=xrowt, colq=colqt, dst=dstt))
        top = TopSolve(t=t, lev0=int(lev0), gather=gather, xmap=xmap,
                       supd=top_supd)

    if cc is not None:
        cc64 = cc.astype(np.float64)
        flops = float(np.sum(cc64 * cc64))
    else:
        flops = float(n + 2 * (len(rows) - n))
    if with_updates and len(cpair):
        qp = qpad[cpair]
        gemm_flops = float(np.sum(
            2.0 * cmc * qp * (wpad[dd[cpair]] + wpad[ss[cpair]])))
    else:
        gemm_flops = 0.0
    return SupernodalPlan(n=n, layout=layout, lev=lev, nlev=nlev,
                          nshards=G, segments=segments, flops=flops,
                          gemm_flops=gemm_flops, nrows=nrows,
                          npanels=npanels_pad, bmap=bmap, top=top,
                          solve_nseg=s0, slotw=slotw,
                          gpool_mb=int(config.solve_gpool_mb),
                          fin_chol_elems=int(config.fin_bucket_elems))
