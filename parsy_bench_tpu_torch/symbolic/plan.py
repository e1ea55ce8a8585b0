"""Simplicial execution plans: the inspector -> executor contract.

The inspector runs once per sparsity pattern on the host and emits a
``SimplicialPlan``: static, level-grouped index arrays that turn the numeric
phase into a fixed sequence of gather / multiply / scatter-add steps over the
factor value vector.  This replaces the reference's pointer-chasing executor
loops (sereial_Cholesky_01.h:13, Triangular_CSC.h:14/50) with a form XLA can
compile: one batched step per wavefront level, no data-dependent control
flow, no atomics — concurrent scatter-subtract becomes ``.at[].add`` (the
TPU-native replacement for ``omp atomic``, SURVEY P7).

Level semantics: lev[j] of the etree (or of the DAG of a general L) is the
earliest step at which column j may be finalized; updates *out of* level-t
columns are applied immediately after the level-t columns are scaled, exactly
the wavefront (H1) schedule of the reference (Parallel_PB_Cholesky_wavefront
.h:35, Triangular_CSC.h:50 lsolvePar).

The port's own copy of ``parsy_bench_tpu/symbolic/plan.py`` (the reference);
only the package in its imports differs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from parsy_bench_tpu_torch.core.csc import CSC, IDX
from parsy_bench_tpu_torch.native import lib as _native
from parsy_bench_tpu_torch.symbolic.etree import etree as _etree, tree_levels


@dataclasses.dataclass
class LevelSlices:
    """Flat array(s) + per-level offsets (static Python ints for jit)."""
    offsets: np.ndarray  # (nlev+1,) int64

    def rng(self, t: int) -> tuple[int, int]:
        return int(self.offsets[t]), int(self.offsets[t + 1])


@dataclasses.dataclass
class SimplicialPlan:
    """Level-scheduled index plan for one lower-triangular pattern L.

    Drives: simplicial left-looking Cholesky, forward solve L x = b, and
    backward solve L^T x = b, all with the same arrays.
    """

    n: int
    nnz: int
    nlev: int
    lptr: np.ndarray            # (n+1,)   int64  L column pointers
    lind: np.ndarray            # (nnz,)   int32  L row indices (sorted)
    lev: np.ndarray             # (n,)     int64  level of each column

    # --- per-column, grouped by level ---------------------------------
    col_off: np.ndarray         # (nlev+1,)
    cols: np.ndarray            # (n,)   int32  column ids, level-grouped
    diag: np.ndarray            # (n,)   int32  position of diag(col) in Lx

    # --- per off-diagonal entry, grouped by level of its column -------
    off_off: np.ndarray         # (nlev+1,)
    off_idx: np.ndarray         # int32  position in Lx
    off_row: np.ndarray         # int32  global row index
    off_lcol: np.ndarray        # int32  index of its column within the level

    # --- update triples, grouped by level of the source column --------
    upd_off: np.ndarray         # (nlev+1,)
    upd_a: np.ndarray           # int32  position of L[i, k]
    upd_b: np.ndarray           # int32  position of L[j, k]
    upd_dst: np.ndarray         # int32  position of L[i, j]

    # --- A -> L injection ----------------------------------------------
    a_map: np.ndarray           # (nnz(A),) int32: Lx[a_map] += A.data

    @property
    def flops_factor(self) -> float:
        """2 flops per update + per column: 1 sqrt + (cc-1) div."""
        return 2.0 * len(self.upd_a) + float(self.nnz)

    @property
    def flops_trisolve(self) -> float:
        """1 div per column + 2 flops per off-diagonal nonzero (reference:
        flopCoutLSolve, triangularSolve/Triangular_CSC.h:31)."""
        return float(self.n) + 2.0 * len(self.off_idx)


def _group_by_level(lev_of_item: np.ndarray, nlev: int):
    """stable order grouping items by level; returns (order, offsets)."""
    order = np.argsort(lev_of_item, kind="stable")
    counts = np.bincount(lev_of_item, minlength=nlev)
    offsets = np.zeros(nlev + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return order, offsets


def _entry_keys(indptr: np.ndarray, indices: np.ndarray, n: int) -> np.ndarray:
    col = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    return col * np.int64(n + 1) + indices.astype(np.int64)


def _updates_numpy(lptr, lind, counts_per_col):
    """NumPy specification of pbt_cholesky_updates (see symbolic.cpp)."""
    total = int(counts_per_col.sum())
    srca = np.empty(total, dtype=IDX)
    srcb = np.empty(total, dtype=IDX)
    dst = np.empty(total, dtype=IDX)
    c = 0
    n = len(lptr) - 1
    for k in range(n):
        base = int(lptr[k])
        o = lind[base + 1:int(lptr[k + 1])]
        m = len(o)
        for jj in range(m):
            j = int(o[jj])
            colj = lind[int(lptr[j]):int(lptr[j + 1])]
            pos = int(lptr[j]) + np.searchsorted(colj, o[jj:])
            cnt = m - jj
            srca[c:c + cnt] = base + 1 + np.arange(jj, m)
            srcb[c:c + cnt] = base + 1 + jj
            dst[c:c + cnt] = pos
            c += cnt
    assert c == total
    return srca, srcb, dst


def plan_from_pattern(lpat: sp.csc_matrix, lev: np.ndarray,
                      a: CSC | None = None,
                      with_updates: bool = True) -> SimplicialPlan:
    """Build a SimplicialPlan for lower-triangular pattern ``lpat``.

    ``lev`` is the per-column level (etree wavefront level for a factor
    pattern; DAG longest-path level for a general L).  ``a`` (lower CSC,
    pattern subset of L) provides the A -> L injection map for Cholesky.
    """
    n = lpat.shape[0]
    lptr = lpat.indptr.astype(np.int64)
    lind = lpat.indices.astype(IDX)
    nnz = int(lptr[-1])
    lev = np.asarray(lev, dtype=np.int64)
    nlev = int(lev.max(initial=-1)) + 1

    # diagonal must be first in each column (rows sorted, diag present)
    if not np.array_equal(lind[lptr[:-1]], np.arange(n, dtype=IDX)):
        raise ValueError("pattern must contain the diagonal as first row of "
                         "each column")

    # per-column arrays grouped by level
    col_order, col_off = _group_by_level(lev, nlev)
    cols = col_order.astype(IDX)
    diag = lptr[col_order].astype(IDX)
    # local index of each column within its level
    lcol = np.empty(n, dtype=np.int64)
    for_level_start = col_off[lev]          # start offset of each col's level
    rank = np.empty(n, dtype=np.int64)
    rank[col_order] = np.arange(n)
    lcol = rank - for_level_start           # position within its level

    # off-diagonal entries grouped by column level
    entry_col = np.repeat(np.arange(n, dtype=np.int64), np.diff(lptr))
    is_off = lind != entry_col
    off_pos = np.nonzero(is_off)[0]
    off_order, off_off = _group_by_level(lev[entry_col[off_pos]], nlev)
    off_sel = off_pos[off_order]
    off_idx = off_sel.astype(IDX)
    off_row = lind[off_sel]
    off_lcol = lcol[entry_col[off_sel]].astype(IDX)

    # update triples grouped by source-column level
    if with_updates:
        m = np.diff(lptr) - 1
        counts = (m * (m + 1)) // 2
        total = int(counts.sum())
        if _native is not None:
            srca, srcb, dst = _native.cholesky_updates(lptr, lind, total)
        else:
            srca, srcb, dst = _updates_numpy(lptr, lind, counts)
        upd_lev = np.repeat(lev, counts)
        uorder, upd_off = _group_by_level(upd_lev, nlev)
        upd_a, upd_b, upd_dst = srca[uorder], srcb[uorder], dst[uorder]
    else:
        upd_off = np.zeros(nlev + 1, dtype=np.int64)
        upd_a = upd_b = upd_dst = np.empty(0, dtype=IDX)

    # A -> L injection
    if a is not None:
        akey = _entry_keys(a.indptr.astype(np.int64), a.indices.astype(IDX), n)
        lkey = _entry_keys(lptr, lind, n)
        a_map = np.searchsorted(lkey, akey).astype(IDX)
        if not np.array_equal(lkey[a_map], akey):
            raise ValueError("pattern of A is not a subset of L")
    else:
        a_map = np.empty(0, dtype=IDX)

    return SimplicialPlan(
        n=n, nnz=nnz, nlev=nlev, lptr=lptr, lind=lind, lev=lev,
        col_off=col_off, cols=cols, diag=diag,
        off_off=off_off, off_idx=off_idx, off_row=off_row, off_lcol=off_lcol,
        upd_off=upd_off, upd_a=upd_a, upd_b=upd_b, upd_dst=upd_dst,
        a_map=a_map)


def cholesky_plan(a: CSC, parent: np.ndarray | None = None):
    """Symbolic Cholesky: pattern of L + level-scheduled plan for ``a``
    (lower CSC, already permuted).  Returns (lpat, plan)."""
    from parsy_bench_tpu_torch.symbolic.colcounts import symbolic_pattern
    if not a.is_lower():
        a = a.lower_half()
    if parent is None:
        parent = _etree(a)
    lpat = symbolic_pattern(a, parent)
    lev = tree_levels(parent)
    return lpat, plan_from_pattern(lpat, lev, a=a, with_updates=True)


def dag_levels(lpat: sp.csc_matrix) -> np.ndarray:
    """Longest-path level of each column in the DAG of lower-triangular L
    (edge j -> i per off-diagonal entry).  For general, non-chordal L where
    no etree exists (reference: buildLevelSet_CSC,
    triangularSolve/Inspection_Level.h:12)."""
    n = lpat.shape[0]
    lptr = lpat.indptr.astype(np.int64)
    lind = lpat.indices.astype(IDX)
    if _native is not None:
        return _native.dag_levels(lptr, lind)
    lev = np.zeros(n, dtype=np.int64)
    for j in range(n):
        lj = lev[j] + 1
        for p in range(lptr[j], lptr[j + 1]):
            i = lind[p]
            if i != j and lev[i] < lj:
                lev[i] = lj
    return lev


def trisolve_plan(l: CSC) -> tuple[np.ndarray, SimplicialPlan]:
    """Plan for solving with a given numeric lower-triangular L (values
    laid out in L's own CSC order).  Returns (levels, plan)."""
    lpat = sp.csc_matrix(
        (np.ones(l.nnz, dtype=np.int8), l.indices, l.indptr), shape=(l.n, l.n))
    lev = dag_levels(lpat)
    return lev, plan_from_pattern(lpat, lev, a=None, with_updates=False)
