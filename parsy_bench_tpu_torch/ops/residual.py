"""The residual of iterative refinement on the device: r = b - A x in
float64, A symmetric and held as its lower half in CSC order (the
analysed pattern in the factor's order, ``CholeskySolver.ap``).

``SymmetricResidual`` keeps, on the device, one list of the products
that both triangles need: each stored entry (i, j) once as A[i, j] x[j]
into y[i], and each one off the diagonal once more as A[i, j] x[i] into
y[j].  A call is five device operations on any device, in this order:
b's copy into r, the gathers of the values and of x, their product, and
one ``index_add_`` of the products into r with the sign flipped
(``benchmark/refinetrace.py`` reads them in that order).
"""
from __future__ import annotations

import numpy as np
import torch


class SymmetricResidual:
    """r = b - A x for the symmetric A whose lower half has the CSC
    pattern (``indptr``, ``indices``), on ``device``."""

    def __init__(self, indptr, indices, device: torch.device):
        indptr = np.asarray(indptr, dtype=np.int64)
        n = len(indptr) - 1
        rows = np.asarray(indices, dtype=np.int64)
        cols = np.repeat(np.arange(n), np.diff(indptr))
        off = np.flatnonzero(rows != cols)
        if len(rows) + len(off) >= 2**31:
            raise ValueError(f"{len(rows) + len(off)} products exceed the "
                             f"int32 indices")

        def up(*parts):
            return torch.as_tensor(np.concatenate(parts).astype(np.int32),
                                   device=device)
        #: product e adds vals[_val[e]] * x[_src[e]] to y[_dst[e]]
        self._dst = up(rows, cols[off])
        self._src = up(cols, rows[off])
        self._val = up(np.arange(len(rows)), off)

    def __call__(self, vals: torch.Tensor, b: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
        r = b.clone()
        prod = vals.index_select(0, self._val) * x.index_select(0, self._src)
        return r.index_add_(0, self._dst, prod, alpha=-1)
