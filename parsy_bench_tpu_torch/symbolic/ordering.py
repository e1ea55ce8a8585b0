"""Fill-reducing orderings.

Reference: LSparsity.h:446-621 selects GIVEN / SCOTCH / METIS node-ND / AMD.
Here the menu is:

* ``natural`` — identity;
* ``given``   — user permutation (reference GIVEN path, LSparsity.h:446);
* ``rcm``     — reverse Cuthill-McKee (scipy.csgraph) — bandwidth reducer;
* ``amd``     — minimum-degree class: native C++ AMD when built, otherwise
  SuperLU's MMD(A^T+A) via scipy.splu (reference AMD path, LSparsity.h:614);
* ``nd``      — nested dissection (the METIS_NodeND stand-in,
  LSparsity.h:534-613; METIS is not available in this environment):
  geometric coordinate bisection when node coordinates are available,
  otherwise coordinate-free BFS level-structure bisection (George-Liu
  pseudo-peripheral root + smallest middle level as the separator).

All return ``perm`` with the convention **perm[new] = old**, i.e. the
reordered matrix is A(perm, perm).

The port's own copy of ``parsy_bench_tpu/symbolic/ordering.py`` (the
reference); only the package in its imports differs.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph

from parsy_bench_tpu_torch.core.csc import CSC, IDX
from parsy_bench_tpu_torch.native import lib as _native


def compute_ordering(a: CSC, method: str = "amd",
                     given_perm=None) -> np.ndarray:
    n = a.n
    if method == "natural":
        return np.arange(n, dtype=IDX)
    if method == "given":
        perm = np.asarray(given_perm, dtype=IDX)
        check_permutation(perm, n)
        return perm
    full = a.symmetrize_from_lower().to_scipy() if a.is_lower() else a.to_scipy()
    if method == "rcm":
        return csgraph.reverse_cuthill_mckee(full.tocsr(), symmetric_mode=True
                                             ).astype(IDX)
    if method == "amd":
        if _native is not None and hasattr(_native, "amd_order"):
            return _native.amd_order(full)
        return _mmd_via_superlu(full)
    if method == "nd":
        # BFS level-structure ND needs no geometry and measures better
        # fill than the coordinate bisection even when coords exist
        # (scripts/diag_r3.py comparison), so it is the primary path.
        # The C++ driver removes the per-bisection scipy submatrix cost
        # (~19 s of the n=262k inspector, RESULTS_r04).
        if _native is not None and hasattr(_native, "nd_order"):
            perm = _native.nd_order(full).astype(IDX)
            check_permutation(perm, a.n)
            return perm
        return _graph_nd(full)
    if method == "nd-geo":
        if a.coords is None:
            raise ValueError("nd-geo needs node coordinates")
        return _geometric_nd(full, a.coords)
    raise ValueError(f"unknown ordering method {method!r}")


def check_permutation(perm: np.ndarray, n: int) -> None:
    """Bijection check (reference: LSparsity.h:626-636)."""
    if len(perm) != n or not np.array_equal(np.sort(perm), np.arange(n)):
        raise ValueError("perm is not a permutation of 0..n-1")


def _mmd_via_superlu(full: sp.spmatrix) -> np.ndarray:
    """Multiple-minimum-degree on A^T+A through SuperLU.  Used only as the
    ordering oracle; the numeric LU it performs as a side effect is wasted
    host work, which is why the native AMD replaces this path."""
    from scipy.sparse.linalg import splu
    n = full.shape[0]
    try:
        lu = splu(full.tocsc(), permc_spec="MMD_AT_PLUS_A",
                  options=dict(SymmetricMode=True, DiagPivotThresh=0.0))
        # SuperLU's perm_c maps old -> new; our contract is perm[new] = old,
        # so A(perm, perm) is the reordered matrix — invert it.
        perm = np.argsort(lu.perm_c).astype(IDX)
        check_permutation(perm, n)
        return perm
    except Exception:
        return csgraph.reverse_cuthill_mckee(full.tocsr(),
                                             symmetric_mode=True).astype(IDX)


def _nd_driver(adj: sp.csr_matrix, bisect, leaf_size: int) -> np.ndarray:
    """Iterative nested-dissection driver (no recursion — VERDICT r2 weak
    #6): ``bisect(nodes) -> (left, right, sep)`` partitions a node set;
    children are ordered before their separator so elimination proceeds
    leaves -> separators, the defining property of nested dissection.
    """
    n = adj.shape[0]

    def order_leaf(nodes: np.ndarray) -> np.ndarray:
        if len(nodes) <= 1:
            return nodes
        sub = adj[nodes][:, nodes]
        local = csgraph.reverse_cuthill_mckee(sub.tocsr(),
                                              symmetric_mode=True)
        return nodes[local]

    parts: list[np.ndarray] = []
    # frames: ("split", nodes) partitions further; ("emit", nodes) appends
    # a finished separator.  Push order (emit-sep, right, left) makes the
    # pop order left-parts, right-parts, separator.
    stack = [("split", np.arange(n, dtype=np.int64))]
    while stack:
        tag, nodes = stack.pop()
        if tag == "emit":
            parts.append(nodes)
            continue
        if len(nodes) <= leaf_size:
            parts.append(order_leaf(nodes))
            continue
        split = bisect(nodes)
        if split is None:
            parts.append(order_leaf(nodes))
            continue
        left, right, sep = split
        stack.append(("emit", sep))
        if len(right):
            stack.append(("split", right))
        if len(left):
            stack.append(("split", left))
    perm = np.concatenate([p for p in parts if len(p)]).astype(IDX)
    check_permutation(perm, n)
    return perm


def _geometric_nd(full: sp.spmatrix, coords: np.ndarray,
                  leaf_size: int = 48) -> np.ndarray:
    """Nested dissection by coordinate bisection: split the node set at the
    median of its widest coordinate; the separator is the boundary layer of
    the left part (nodes with a neighbour on the right)."""
    adj = full.tocsr()

    def bisect(nodes: np.ndarray):
        c = coords[nodes]
        spread = c.max(axis=0) - c.min(axis=0)
        axis = int(np.argmax(spread))
        med = np.median(c[:, axis])
        left_mask = c[:, axis] <= med
        if left_mask.all() or not left_mask.any():
            left_mask = c[:, axis] < med
            if left_mask.all() or not left_mask.any():
                return None
        left = nodes[left_mask]
        right = nodes[~left_mask]
        # separator: left nodes adjacent to right nodes
        in_right = np.zeros(adj.shape[0], dtype=bool)
        in_right[right] = True
        sub = adj[left]
        indptr, indices = sub.indptr, sub.indices
        touches = np.add.reduceat(in_right[indices].astype(np.int64),
                                  indptr[:-1],
                                  dtype=np.int64) > 0 \
            if len(indices) else np.zeros(len(left), dtype=bool)
        touches[np.diff(indptr) == 0] = False
        return left[~touches], right, left[touches]

    return _nd_driver(adj, bisect, leaf_size)


def _bfs_levels(indptr: np.ndarray, indices: np.ndarray, nloc: int,
                root: int) -> np.ndarray:
    """BFS level of every node of a (local, CSR) graph from ``root``;
    unreached nodes get -1.  Frontier expansion is vectorized (one
    np.repeat/concatenate round per level)."""
    lev = np.full(nloc, -1, dtype=np.int64)
    lev[root] = 0
    frontier = np.array([root], dtype=np.int64)
    d = 0
    while len(frontier):
        d += 1
        cnt = indptr[frontier + 1] - indptr[frontier]
        total = int(cnt.sum())
        if total == 0:
            break
        owner = np.repeat(np.arange(len(frontier)), cnt)
        off = np.concatenate([[0], np.cumsum(cnt)])[owner]
        flat = indptr[frontier][owner] + (np.arange(total) - off)
        nbr = indices[flat]
        new = np.unique(nbr[lev[nbr] < 0])
        lev[new] = d
        frontier = new
    return lev


def _graph_nd(full: sp.spmatrix, leaf_size: int = 48) -> np.ndarray:
    """Coordinate-free nested dissection (the METIS_NodeND stand-in for
    real .mtx inputs, reference LSparsity.h:534-613).

    Bisection is George-Liu level-structure based: BFS from a
    pseudo-peripheral root gives levels; the separator is the smallest
    level whose cumulative node count lies in the middle band (every
    path from shallower to deeper levels crosses it, so it is a valid
    vertex separator).  Disconnected pieces split for free.
    """
    adj = full.tocsr()

    def bisect(nodes: np.ndarray):
        # local subgraph (local indices 0..m-1)
        m = len(nodes)
        sub = adj[nodes][:, nodes].tocsr()
        indptr = sub.indptr.astype(np.int64)
        indices = sub.indices.astype(np.int64)
        lev = _bfs_levels(indptr, indices, m, 0)
        un = lev < 0
        if un.any():
            # disconnected: peel the reached component, no separator needed
            return nodes[~un], nodes[un], nodes[:0]
        # pseudo-peripheral: restart BFS from a farthest node (one round
        # of the George-Liu iteration is enough in practice)
        root = int(np.argmax(lev))
        lev = _bfs_levels(indptr, indices, m, root)
        nlev = int(lev.max()) + 1
        if nlev <= 2:
            return None  # clique-ish: no useful level separator
        sizes = np.bincount(lev, minlength=nlev)
        cum = np.cumsum(sizes)
        lo = np.searchsorted(cum, 0.25 * m)
        hi = np.searchsorted(cum, 0.75 * m)
        lo = max(1, min(int(lo), nlev - 2))
        hi = max(lo, min(int(hi), nlev - 2))
        band = np.arange(lo, hi + 1)
        cut = int(band[np.argmin(sizes[band])])
        return (nodes[lev < cut], nodes[lev > cut], nodes[lev == cut])

    return _nd_driver(adj, bisect, leaf_size)
