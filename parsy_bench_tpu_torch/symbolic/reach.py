"""Reach sets.

Reference: common/Reach.h — ``reach`` (DFS closure of an RHS pattern in the
DAG of L, for pruned sparse-RHS triangular solves, P4) and ``ereach``
(row pattern of L via etree traversal, driving the left-looking update loop).

The port's own copy of ``parsy_bench_tpu/symbolic/reach.py`` (the
reference); only the package in its imports differs.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from parsy_bench_tpu_torch.core.csc import CSC, IDX


def ereach(a: CSC, parent: np.ndarray, k: int, *, upper=None) -> np.ndarray:
    """Pattern of row k of L (excluding the diagonal), ascending.

    These are exactly the columns j < k whose update touches column k in
    left-looking factorization (reference: ``ereach`` common/Reach.h:89).

    Callers iterating over many rows should pass ``upper`` — the CSC upper
    triangle ``a.to_scipy().T.tocsc()`` computed once — to avoid the
    O(nnz) transpose per call.
    """
    if upper is None:
        upper = a.to_scipy().T.tocsc()
    indptr, indices = upper.indptr, upper.indices
    seen = set()
    out: list[int] = []
    for p in range(indptr[k], indptr[k + 1]):
        j = int(indices[p])
        path = []
        while j != -1 and j < k and j not in seen:
            path.append(j)
            seen.add(j)
            j = int(parent[j])
        out.extend(path)
    return np.array(sorted(out), dtype=IDX)


def reach_sn(rptr: np.ndarray, rows: np.ndarray, sptr: np.ndarray,
             col2sup: np.ndarray, rhs_rows: np.ndarray) -> np.ndarray:
    """Supernodal reach: every supernode touched when solving L x = b with
    b nonzero only at ``rhs_rows``, over the blocked pattern (rptr, rows,
    sptr, col2sup) — the closure of the RHS supernodes under the
    supernode DAG edge d -> s when a below-diagonal row of d lies in s
    (reference: ``reach_sn`` common/Reach.h:31, which maps the scalar
    reach onto supernodes for blockedPrunedLSolve, Triangular_BCSC.h:55).

    Returns ascending supernode indices (ascending = topological)."""
    nsuper = len(rptr) - 1
    active = np.zeros(nsuper, dtype=bool)
    stack = list(np.unique(col2sup[np.asarray(rhs_rows, dtype=np.int64)]))
    for s in stack:
        active[s] = True
    while stack:
        d = stack.pop()
        w = sptr[d + 1] - sptr[d]
        below = rows[rptr[d] + w:rptr[d + 1]]
        for t in np.unique(col2sup[below]):
            if not active[t]:
                active[t] = True
                stack.append(t)
    return np.nonzero(active)[0].astype(IDX)


def reach(l_pattern: sp.csc_matrix, rhs_rows: np.ndarray) -> np.ndarray:
    """All rows touched when solving L x = b with b nonzero only at
    ``rhs_rows``: the DFS closure of rhs_rows under edges j -> i for
    L[i, j] != 0 (reference: ``reach`` common/Reach.h:14).

    Returned in ascending (= topological for lower-triangular L) order.
    """
    n = l_pattern.shape[0]
    indptr, indices = l_pattern.indptr, l_pattern.indices
    visited = np.zeros(n, dtype=bool)
    stack = list(np.asarray(rhs_rows, dtype=np.int64))
    for r in stack:
        visited[r] = True
    while stack:
        j = stack.pop()
        for p in range(indptr[j], indptr[j + 1]):
            i = indices[p]
            if not visited[i]:
                visited[i] = True
                stack.append(i)
    return np.nonzero(visited)[0].astype(IDX)
