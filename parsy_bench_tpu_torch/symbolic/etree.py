"""Elimination tree and tree utilities.

Host-side symbolic kernels (reference: common/Etree.h, common/PostOrder.h,
common/TreeUtils.h).  These are irregular pointer-chasing algorithms that run
once per sparsity pattern; a C++ fast path (parsy_bench_tpu_torch.native)
replaces the Python loops when available — the NumPy implementations here
are the specification and the fallback.

All tree functions exploit the elimination-tree invariant parent[j] > j
(a topological numbering), which turns every traversal into a single linear
pass; callers must hand in etrees / supernodal etrees, not arbitrary forests.

The port's own copy of ``parsy_bench_tpu/symbolic/etree.py`` (the
reference); only the package in its imports differs.
"""
from __future__ import annotations

import numpy as np

from parsy_bench_tpu_torch.core.csc import CSC, IDX
from parsy_bench_tpu_torch.native import lib as _native


def _check_topological(parent: np.ndarray) -> None:
    j = np.arange(len(parent))
    if not np.all((parent == -1) | (parent > j)):
        raise ValueError("parent[] must be topologically numbered (parent[j] > j)")


def etree(a: CSC) -> np.ndarray:
    """Elimination tree of SPD ``a`` given in lower-half CSC.

    Returns parent[j] (int32, -1 at roots).  Liu's algorithm with path
    compression (reference: ``etreeC`` common/Etree.h:56).
    """
    if not a.is_lower():
        a = a.lower_half()
    # row-wise access to the lower triangle == CSC of the upper half:
    # column i of ``at`` holds the j <= i entries of row i of A.
    at = a.to_scipy().T.tocsc()
    n = a.n
    indptr = at.indptr.astype(np.int64)
    indices = at.indices.astype(IDX)
    if _native is not None:
        return _native.etree(n, indptr, indices)
    parent = np.full(n, -1, dtype=IDX)
    ancestor = np.full(n, -1, dtype=IDX)
    for i in range(n):
        for p in range(indptr[i], indptr[i + 1]):
            j = indices[p]
            while j != -1 and j < i:
                nxt = ancestor[j]
                ancestor[j] = i
                if nxt == -1:
                    parent[j] = i
                j = nxt
    return parent


def tree_children(parent: np.ndarray):
    """CSR-style children lists ordered by child id: returns
    (childptr, children, roots) (reference: ``populateChildren``
    common/TreeUtils.h:34)."""
    n = len(parent)
    order = np.argsort(parent, kind="stable").astype(IDX)
    nroots = int(np.sum(parent == -1))  # -1 sorts first
    childptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(childptr[1:], parent[parent >= 0], 1)
    np.cumsum(childptr, out=childptr)
    return childptr, order[nroots:], order[:nroots]


def subtree_accumulate(parent: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Sum of ``values`` over each subtree (reference: ``computeSubtreeCost``
    common/TreeUtils.h:103)."""
    _check_topological(parent)
    out = np.asarray(values, dtype=np.float64).copy()
    if _native is not None:
        _native.subtree_accumulate(parent.astype(IDX), out)
        return out
    for j in range(len(parent)):
        p = parent[j]
        if p >= 0:
            out[p] += out[j]
    return out


def subtree_sizes(parent: np.ndarray) -> np.ndarray:
    return subtree_accumulate(parent, np.ones(len(parent))).astype(np.int64)


def postorder(parent: np.ndarray, weights: np.ndarray | None = None) -> np.ndarray:
    """Postorder of the forest; ``post[k]`` = node visited k-th.

    With ``weights`` children are visited in ascending subtree-weight order —
    the CHOLMOD weighted postorder the reference uses to improve supernode
    contiguity (common/PostOrder.h:11 ``postOrderC``).
    """
    n = len(parent)
    childptr, children, roots = tree_children(parent)
    if weights is not None:
        w = subtree_accumulate(parent, np.asarray(weights, dtype=np.float64))
        # reorder every parent's child run by subtree weight in one
        # lexsort (owner, weight, id) — the per-parent Python loop this
        # replaces was an O(n)-iteration inspector hot spot at n ~ 10^5+
        owner = np.repeat(np.arange(n, dtype=np.int64),
                          np.diff(childptr))
        children = children[np.lexsort((children, w[children], owner))]
        roots = roots[np.argsort(w[roots], kind="stable")].astype(IDX)
    if _native is not None:
        return _native.postorder(n, childptr, children.astype(IDX),
                                 roots.astype(IDX))
    post = np.empty(n, dtype=IDX)
    stack = np.empty(n, dtype=np.int64)
    cursor = childptr[:-1].copy()
    k = 0
    for r in roots:
        top = 0
        stack[0] = r
        while top >= 0:
            v = stack[top]
            if cursor[v] < childptr[v + 1]:
                stack[top + 1] = children[cursor[v]]
                cursor[v] += 1
                top += 1
            else:
                post[k] = v
                k += 1
                top -= 1
    assert k == n
    return post


def tree_depths(parent: np.ndarray) -> np.ndarray:
    """Depth below the root (roots = 0) (reference: ``getNodeDepth``
    common/TreeUtils.h:58)."""
    _check_topological(parent)
    n = len(parent)
    depth = np.zeros(n, dtype=np.int64)
    if _native is not None:
        _native.tree_depths(parent.astype(IDX), depth)
        return depth
    for j in range(n - 1, -1, -1):
        p = parent[j]
        if p >= 0:
            depth[j] = depth[p] + 1
    return depth


def tree_levels(parent: np.ndarray) -> np.ndarray:
    """Wavefront level of each node: leaves are 0, lev[j] = 1 + max over
    children — i.e. the earliest step at which node j may execute."""
    _check_topological(parent)
    n = len(parent)
    lev = np.zeros(n, dtype=np.int64)
    if _native is not None:
        _native.tree_wavefront(parent.astype(IDX), lev)
        return lev
    for j in range(n):
        p = parent[j]
        if p >= 0 and lev[j] + 1 > lev[p]:
            lev[p] = lev[j] + 1
    return lev


def tree_height(parent: np.ndarray) -> int:
    """Height of the forest (reference: ``getTreeHeight`` TreeUtils.h:87)."""
    if len(parent) == 0:
        return 0
    return int(tree_levels(parent).max()) + 1


def bucket_by_level(lev: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Group nodes by level: returns CSR-style (level_ptr, level_nodes) with
    nodes of a level in ascending id order (reference: ``getLevelSet``
    TreeUtils.h:119)."""
    nlev = int(lev.max(initial=-1)) + 1
    order = np.argsort(lev, kind="stable").astype(IDX)
    ptr = np.zeros(nlev + 1, dtype=np.int64)
    np.add.at(ptr[1:], lev, 1)
    np.cumsum(ptr, out=ptr)
    return ptr, order


def level_sets(parent: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Wavefront level sets of an etree (level_ptr, level_nodes)."""
    return bucket_by_level(tree_levels(parent))
