"""Coarsened DAG schedule for general (non-chordal) triangular solves —
the TPU-native replacement for the reference's DAG-LBC
(``getCoarseLevelSet_DAG_CSC03`` InspectionDAG_03.h:14, connected
components ``dfs_CSC_CC`` DFS.h:99, topo finish ``modifiedBFS`` BFS.h:14).

The reference coarsens wavefront levels into super-levels and splits each
into connected-component w-partitions so each OpenMP thread runs a
dependent chain serially without barriers.  On TPU the serial chain cost
is per-step dispatch, so the coarsening target is different: **contract
whole runs of levels into one dense-block triangular solve step**.

Columns are sorted by (wavefront level, id) — any consecutive W-column
window of that order induces a dense lower-triangular block (an edge
j -> i implies lev[i] > lev[j], so sources precede targets).  Each
coarse step then:

* scatters the window's L entries into a dense (W, W) block,
* solves it with 16-wide sub-block forward substitution whose sub-block
  inverses come from one batched Neumann-product inverse (ops/dense.py),
* applies the window's off-block entries to the RHS carry in one batched
  scatter-add (the ``omp atomic`` replacement, SURVEY P7).

Step count falls from nlev (the DAG depth) to ceil(n / W): a chain-heavy
DAG with thousands of single-column levels collapses ~W levels into each
step.  ``choose_schedule`` picks wavefront vs coarsened from the plan's
own step/work model — the cost-model-driven scheduling the reference does
with per-partition cost bounds (InspectionLevel_06.h:137).

Connected components of level-restricted sub-DAGs (``cc_partition``) are
exposed for scaling statistics and shard assignment, mirroring the
reference's w-partition reporting.

The port's own copy of ``parsy_bench_tpu/symbolic/dagplan.py`` (the
reference); only the package in its imports differs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from parsy_bench_tpu_torch.core.csc import CSC, IDX


#: dense coarse-block width (multiple of the 16-wide sub-block solver)
COARSE_W = 256
_SUB = 16


@dataclasses.dataclass
class CoarseTrisolvePlan:
    """Padded per-step tables for the coarsened dense-block schedule."""
    n: int
    nnz: int
    W: int
    nsteps: int
    nlev: int                 # wavefront depth, for comparison/reporting
    cols: np.ndarray          # (S, W)  column ids; pad -> n
    diag: np.ndarray          # (S, W)  diag positions in lx; pad -> nnz
    bpos: np.ndarray          # (S, Kb) in-block entry positions; pad -> nnz
    brc: np.ndarray           # (S, Kb) local row*W + col of entry; pad last
    opos: np.ndarray          # (S, Ko) off-block entry positions; pad -> nnz
    orow: np.ndarray          # (S, Ko) global row; pad -> n
    ocol: np.ndarray          # (S, Ko) local col in window; pad -> W

    @property
    def flops_trisolve(self) -> float:
        return float(self.n) + 2.0 * float(np.sum(self.opos < self.nnz)
                                           + np.sum(self.bpos < self.nnz))


def cc_partition(lpat: sp.csc_matrix, lev: np.ndarray,
                 t0: int, t1: int) -> np.ndarray:
    """Connected components of the DAG restricted to levels [t0, t1) —
    the reference's per-super-level w-partition seed (dfs_CSC_CC DFS.h:99).
    Returns component id per restricted column (-1 outside).

    Reporting/analysis API only (VERDICT r2 weak #9): the executor's
    shard assignment is cost-packed per bucket (splan._shard_of) rather
    than component-based, because on TPU the update lanes of one level
    are data-parallel regardless of component structure; components
    remain useful for diagnosing how much independent coarse-grain
    parallelism a pattern offers (eval/analysis tooling)."""
    n = lpat.shape[0]
    sel = (lev >= t0) & (lev < t1)
    idx = np.nonzero(sel)[0]
    loc = np.full(n, -1, dtype=np.int64)
    loc[idx] = np.arange(len(idx))
    coo = lpat.tocoo()
    m = (coo.row != coo.col) & sel[coo.row] & sel[coo.col]
    g = sp.csr_matrix(
        (np.ones(int(m.sum()), dtype=np.int8),
         (loc[coo.row[m]], loc[coo.col[m]])),
        shape=(len(idx), len(idx)))
    ncc, cc = sp.csgraph.connected_components(g, directed=False)
    out = np.full(n, -1, dtype=np.int64)
    out[idx] = cc
    return out


def build_coarse_trisolve(l: CSC, lev: np.ndarray,
                          W: int = COARSE_W) -> CoarseTrisolvePlan:
    """Emit the coarse schedule for a numeric lower-triangular L."""
    n = l.n
    lptr = l.indptr.astype(np.int64)
    lind = l.indices.astype(np.int64)
    nnz = int(lptr[-1])
    if W % _SUB:
        raise ValueError(f"W must be a multiple of {_SUB}")
    # the schedule reads each column's diagonal at its first stored entry;
    # unsorted indices or a missing explicit diagonal would be silently
    # wrong solves (ADVICE r2)
    if not np.array_equal(lind[lptr[:-1]], np.arange(n)):
        raise ValueError("L must store a sorted explicit diagonal as the "
                         "first entry of every column")
    order = np.lexsort((np.arange(n), np.asarray(lev)))
    pos_of = np.empty(n, dtype=np.int64)       # column -> window position
    pos_of[order] = np.arange(n)
    S = -(-n // W)
    grp_of = pos_of // W
    loc_of = pos_of % W

    cols = np.full((S, W), n, dtype=np.int32)
    diag = np.full((S, W), nnz, dtype=np.int32)
    cols[grp_of, loc_of] = np.arange(n)
    diag[grp_of, loc_of] = lptr[:-1]

    # entry partition: same window (dense block) vs off-block
    ecol = np.repeat(np.arange(n, dtype=np.int64), np.diff(lptr))
    off = lind != ecol                          # off-diagonal entries
    epos = np.nonzero(off)[0]
    ei, ej = lind[epos], ecol[epos]
    same = grp_of[ei] == grp_of[ej]
    g_in = grp_of[ej[same]]
    # in-block: local (row, col)
    kb = np.bincount(g_in, minlength=S)
    Kb = max(1, int(kb.max(initial=0)))
    bpos = np.full((S, Kb), nnz, dtype=np.int32)
    brc = np.full((S, Kb), W * W, dtype=np.int32)
    o1 = np.lexsort((epos[same], g_in))
    lane = np.arange(len(o1)) - np.concatenate(
        [[0], np.cumsum(kb)])[g_in[o1]]
    bpos[g_in[o1], lane] = epos[same][o1]
    brc[g_in[o1], lane] = (loc_of[ei[same][o1]] * W
                           + loc_of[ej[same][o1]])
    # off-block
    g_out = grp_of[ej[~same]]
    ko = np.bincount(g_out, minlength=S)
    Ko = max(1, int(ko.max(initial=0)))
    opos = np.full((S, Ko), nnz, dtype=np.int32)
    orow = np.full((S, Ko), n, dtype=np.int32)
    ocol = np.full((S, Ko), W, dtype=np.int32)
    o2 = np.lexsort((epos[~same], g_out))
    lane2 = np.arange(len(o2)) - np.concatenate(
        [[0], np.cumsum(ko)])[g_out[o2]]
    opos[g_out[o2], lane2] = epos[~same][o2]
    orow[g_out[o2], lane2] = ei[~same][o2]
    ocol[g_out[o2], lane2] = loc_of[ej[~same][o2]]

    return CoarseTrisolvePlan(
        n=n, nnz=nnz, W=W, nsteps=S,
        nlev=int(np.asarray(lev).max(initial=-1)) + 1,
        cols=cols, diag=diag, bpos=bpos, brc=brc,
        opos=opos, orow=orow, ocol=ocol)


def choose_schedule(l: CSC, lev: np.ndarray, W: int = COARSE_W,
                    step_cost: float = 64.0) -> str:
    """Pick "wavefront" or "coarsened" from a step-count model: each
    schedule pays ~step_cost units of fixed dispatch per step plus its
    padded work; chains (nlev >> n/W) favour coarsening, wide shallow DAGs
    favour the wavefront (the reference makes the same trade with
    per-partition cost bounds, InspectionLevel_06.h:137)."""
    n = l.n
    nlev = int(np.asarray(lev).max(initial=-1)) + 1
    ncoarse = -(-n // W)
    # work per coarse step ~ W*W/8 dense-solve units vs per-level scatter
    wave = step_cost * nlev + 2.0 * l.nnz
    coarse = (step_cost + W * W / 64.0) * ncoarse + 2.0 * l.nnz
    return "coarsened" if coarse < wave else "wavefront"
