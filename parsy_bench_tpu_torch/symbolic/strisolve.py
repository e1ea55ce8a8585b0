"""Supernodal (BCSC) triangular-solve inspector for a given numeric L.

Reference: triangularSolve/Inspection_Block.h — value-pattern supernode
detection (``superNodeDetection`` :7, adjacent columns with identical
off-diagonal pattern), BCSC construction (``createFormat`` :75), and the
level-set scheduling of the supernodal DAG (``buildLevelSet_BCSC``,
Inspection_Level.h:65).  The executor side is ops/supernodal.py's blocked
solves (H2LeveledBlockedLsolve analogue, Triangular_BCSC.h:171).

Unlike the Cholesky path there is no etree: levels are longest paths in the
supernode dependency DAG (edge d -> s when a below-diagonal row of d is a
column of s), which works for chordal and non-chordal L alike (the
reference's triangularTest_DAG_nonChordal.cpp case).

The port's own copy of ``parsy_bench_tpu/symbolic/strisolve.py`` (the
reference); only the package in its imports differs.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from parsy_bench_tpu_torch.core.csc import CSC
from parsy_bench_tpu_torch.config import SolverConfig
from parsy_bench_tpu_torch.symbolic.splan import (
    SupernodalPlan, emit_pairs, plan_from_layout)
from parsy_bench_tpu_torch.symbolic.supernodes import (
    SupernodePartition, build_class_layout, supernodal_rows)


def detect_supernodes_from_pattern(l: sp.csc_matrix,
                                   max_width: int = 128) -> np.ndarray:
    """Start flags: column j+1 joins j's supernode when its pattern equals
    column j's pattern minus row j (identical off-diagonal structure,
    reference superNodeDetection, Inspection_Block.h:7-50).  Vectorized:
    adjacent columns merge iff their index runs match when column j's
    leading diagonal entry is dropped."""
    n = l.shape[0]
    ptr = l.indptr.astype(np.int64)
    ind = l.indices.astype(np.int64)
    cnt = np.diff(ptr)
    start = np.ones(n, dtype=bool)
    if n > 1:
        # candidate columns: j merges into j-1 when col j-1 starts with its
        # diagonal and len(col j-1) == len(col j) + 1
        j = np.arange(1, n)
        cand = (cnt[j - 1] == cnt[j] + 1) & (ind[ptr[j - 1]] == j - 1)
        # compare the remaining runs with a cumulative-mismatch trick:
        # position-wise equality of ind[ptr[j-1]+1 + k] vs ind[ptr[j] + k]
        ks = cnt[1:]  # lengths to compare for each j (when cand)
        total = int(np.sum(ks[cand]))
        if total:
            jj = j[cand]
            owner = np.repeat(np.arange(len(jj)), ks[cand])
            off = np.concatenate([[0], np.cumsum(ks[cand])])[:-1]
            k = np.arange(total) - off[owner]
            eq = ind[ptr[jj - 1][owner] + 1 + k] == ind[ptr[jj][owner] + k]
            ok = np.ones(len(jj), dtype=bool)
            np.logical_and.at(ok, owner, eq)
            start[jj[ok]] = False
    # enforce max width
    sid = np.cumsum(start) - 1
    first = np.zeros(n, dtype=np.int64)
    first[start] = np.nonzero(start)[0]
    first = np.maximum.accumulate(first)
    wide = (np.arange(n) - first) % max_width == 0
    return start | wide


def _dag_levels(dd, ss, nsuper):
    """Longest-path levels of the supernode DAG (reference:
    buildLevelSet_BCSC, Inspection_Level.h:65)."""
    lev = np.zeros(nsuper, dtype=np.int64)
    order = np.argsort(dd, kind="stable")
    for p in order:     # d ascending; d < s always, so one pass suffices
        d, s = int(dd[p]), int(ss[p])
        if lev[d] + 1 > lev[s]:
            lev[s] = lev[d] + 1
    return lev


def build_trisolve_plan(l: CSC, config: SolverConfig | None = None
                        ) -> SupernodalPlan:
    """Inspector for blocked trisolve with a given numeric L: partition by
    value-pattern detection, class layout, DAG levels, finalize buckets
    only (no update pairs — the numeric factor already exists)."""
    config = config or SolverConfig()
    n = l.n
    lpat = sp.csc_matrix((np.ones(l.nnz, dtype=np.int8), l.indices,
                          l.indptr), shape=(n, n))
    start = detect_supernodes_from_pattern(lpat, config.max_supernode_width)
    sptr = np.concatenate([np.nonzero(start)[0], [n]]).astype(np.int64)
    nsuper = len(sptr) - 1
    col2sup = (np.cumsum(start) - 1).astype(np.int32)
    part = SupernodePartition(nsuper, sptr, col2sup,
                              np.full(nsuper, -1, dtype=np.int32))
    rptr, rows = supernodal_rows(lpat, part)
    dd, ss, _, _ = emit_pairs(rptr, rows, sptr, col2sup)
    lev = _dag_levels(dd, ss, nsuper)
    layout = build_class_layout(lpat, l, part, lev, config.width_classes)
    return plan_from_layout(n, layout, cc=None, config=config,
                            with_updates=False)
