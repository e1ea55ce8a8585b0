"""Supernode -> device ownership partitioning for the distributed executor.

The reference models inter-partition traffic with ``computeComCost``
(cholesky/performanceModel.h:194 — intra/inter contribution nnz, edge
cuts) and extracts cost-bounded subtrees with ``postOrderSpliting``
(cholesky/PostOrderSpliting.h:12) packed by ``worstFitBinPack``
(common/TreeUtils.h:217).  Here the same three ideas assign every
supernode an owning device:

* maximal subtrees of the supernodal etree whose cost fits a target are
  the atoms ("chunks");
* chunks go to the currently-lightest device (worst-fit-decreasing);
* top-of-tree nodes (the separators, subtree cost above target) follow
  their heaviest child for locality unless that device is overloaded.

Update pairs whose source and target owners differ are the *boundary*;
the distributed executor communicates only those rows (one ragged psum
of per-class boundary buffers) instead of whole level windows — SURVEY §7E.

The port's own copy of ``parsy_bench_tpu/symbolic/partition.py`` (the
reference): only the imports differ.
"""
from __future__ import annotations

import numpy as np


def supernode_costs(sptr: np.ndarray, cc: np.ndarray) -> np.ndarray:
    """Per-supernode factorization flops: sum of cc_j^2 over its columns
    (the flop count the reference accumulates per node,
    performanceModel.h:117 computeCostColFact4 role)."""
    cs = np.concatenate([[0.0], np.cumsum(cc.astype(np.float64) ** 2)])
    return cs[sptr[1:]] - cs[sptr[:-1]]


def partition_supernodes(sparent: np.ndarray, cost: np.ndarray, G: int,
                         chunks_per_bin: float = 4.0,
                         imbalance: float = 1.15) -> np.ndarray:
    """owner[s] in [0, G) for every supernode.

    Chunk = maximal subtree with cost <= total/(chunks_per_bin*G);
    chunks packed worst-fit-decreasing; separator (top) nodes follow
    their heaviest child unless that bin exceeds ``imbalance`` x average.
    """
    nsuper = len(sparent)
    owner = np.zeros(nsuper, dtype=np.int64)
    if G <= 1 or nsuper == 0:
        return owner
    cost = np.asarray(cost, dtype=np.float64)
    sub = cost.copy()
    for s in range(nsuper):           # sparent[s] > s: single pass
        p = sparent[s]
        if p >= 0:
            sub[p] += sub[s]
    total = float(cost.sum())
    target = max(total / (chunks_per_bin * G), 1.0)

    # chunk assignment: -1 = top node, else index of the chunk root
    chunk_of = np.empty(nsuper, dtype=np.int64)
    for s in range(nsuper - 1, -1, -1):   # parents before children
        if sub[s] > target:
            chunk_of[s] = -1
        else:
            p = sparent[s]
            if p < 0 or sub[p] > target:
                chunk_of[s] = s           # maximal light subtree root
            else:
                chunk_of[s] = chunk_of[p]

    roots = np.nonzero((chunk_of == np.arange(nsuper)))[0]
    load = np.zeros(G, dtype=np.float64)
    chunk_owner = {}
    for r in roots[np.argsort(-sub[roots], kind="stable")]:
        g = int(np.argmin(load))          # worst-fit-decreasing
        chunk_owner[int(r)] = g
        load[g] += sub[r]
    for s in range(nsuper):
        if chunk_of[s] >= 0:
            owner[s] = chunk_owner[int(chunk_of[s])]

    # top nodes: children first (ascending ids), follow heaviest child
    best_child_cost = np.zeros(nsuper, dtype=np.float64)
    best_child_owner = np.full(nsuper, -1, dtype=np.int64)
    cap = imbalance * total / G
    for s in range(nsuper):
        if chunk_of[s] < 0:
            g = int(best_child_owner[s])
            if g < 0 or load[g] + cost[s] > cap:
                g = int(np.argmin(load))
            owner[s] = g
            load[g] += cost[s]
        p = sparent[s]
        if p >= 0 and sub[s] > best_child_cost[p]:
            best_child_cost[p] = sub[s]
            best_child_owner[p] = owner[s]
    return owner


def boundary_fraction(rptr: np.ndarray, rows: np.ndarray,
                      sptr: np.ndarray, col2sup: np.ndarray,
                      owner: np.ndarray) -> dict:
    """Comm-model summary (the computeComCost role): fraction of update
    rows whose source and target supernodes have different owners."""
    from parsy_bench_tpu_torch.symbolic.splan import emit_pairs
    dd, ss, lb, qq = emit_pairs(rptr, rows, sptr, col2sup)
    m = (rptr[dd + 1] - rptr[dd] - lb).astype(np.int64)
    cross = owner[dd] != owner[ss]
    tot = float(m.sum()) or 1.0
    return {
        "pairs": int(len(dd)),
        "cross_pairs": int(cross.sum()),
        "row_fraction_cross": float(m[cross].sum() / tot),
        "per_device_cost": None,
    }
