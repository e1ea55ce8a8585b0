"""Column counts and the symbolic factor pattern.

Reference: common/ColumnCount.h ``rowcolcounts`` (CHOLMOD skeleton algorithm)
and the per-column pattern construction inside Inspection_BlockC.h ``subtree``.
Here both are derived from one primitive — the **row subtree walk**: the
pattern of row i of L is the set of nodes on the etree paths from every
A(i, k), k < i up toward i (Liu).  One pass over all rows costs O(nnz(L))
and yields row counts, column counts, and (optionally) the full pattern.

The port's own copy of ``parsy_bench_tpu/symbolic/colcounts.py`` (the
reference); only the package in its imports differs.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from parsy_bench_tpu_torch.core.csc import CSC, IDX
from parsy_bench_tpu_torch.native import lib as _native


def _rows_lower(a: CSC):
    """(indptr, indices) giving, for each row i, the columns k <= i of the
    lower half — i.e. the CSC of the upper half."""
    if not a.is_lower():
        a = a.lower_half()
    at = a.to_scipy().T.tocsc()
    return at.indptr.astype(np.int64), at.indices.astype(IDX)


def col_counts(a: CSC, parent: np.ndarray) -> np.ndarray:
    """nnz per column of the Cholesky factor L (diagonal included).

    Equivalent to the reference's ``rowcolcounts`` ColCount output
    (common/ColumnCount.h:141), computed by row-subtree marking instead of
    the skeleton/FIND-UNION trick; same O(nnz(L)) class.
    """
    indptr, indices = _rows_lower(a)
    n = a.n
    if _native is not None:
        return _native.col_counts(n, indptr, indices, parent.astype(IDX))
    cc = np.ones(n, dtype=np.int64)  # diagonal
    mark = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        mark[i] = i
        for p in range(indptr[i], indptr[i + 1]):
            j = int(indices[p])
            while j != -1 and mark[j] != i:
                cc[j] += 1
                mark[j] = i
                j = int(parent[j])
    return cc


def symbolic_pattern(a: CSC, parent: np.ndarray) -> sp.csc_matrix:
    """Boolean pattern of L as a scipy CSC (diagonal included).

    Built row-wise by the same subtree walk, then converted; this is the
    simplicial analogue of the reference's supernodal ``Ls`` construction
    (Inspection_BlockC.h:684-752).
    """
    indptr, indices = _rows_lower(a)
    n = a.n
    if _native is not None:
        rptr, rind = _native.symbolic_pattern(n, indptr, indices,
                                              parent.astype(IDX))
    else:
        rows_i: list[np.ndarray] = []
        rptr = np.zeros(n + 1, dtype=np.int64)
        mark = np.full(n, -1, dtype=np.int64)
        buf = np.empty(n, dtype=IDX)
        for i in range(n):
            mark[i] = i
            cnt = 0
            buf[cnt] = i  # diagonal
            cnt += 1
            for p in range(indptr[i], indptr[i + 1]):
                j = int(indices[p])
                while j != -1 and mark[j] != i:
                    buf[cnt] = j
                    cnt += 1
                    mark[j] = i
                    j = int(parent[j])
            rows_i.append(buf[:cnt].copy())
            rptr[i + 1] = rptr[i] + cnt
        rind = np.concatenate(rows_i) if rows_i else np.empty(0, dtype=IDX)
    # row-wise (CSR with column indices) -> CSC
    lcsr = sp.csr_matrix((np.ones(len(rind), dtype=np.int8), rind, rptr),
                         shape=(n, n))
    lcsc = lcsr.tocsc()
    lcsc.sort_indices()
    return lcsc


def factor_flops(cc: np.ndarray) -> float:
    """Cholesky flop count fl = sum(cc_j^2 + cc_j) ~ reference's
    fl = sum cc^2 (ColumnCount.h rowcolcounts; BASELINE OPS_PPF class)."""
    cc = cc.astype(np.float64)
    return float(np.sum(cc * cc))
