"""Host-side sparse containers.

``CSC`` plays the role of the reference's ``CSC`` struct (common/def.h:59) —
a compressed-sparse-column matrix with int32 indices — plus the permute /
transpose / lower-half helpers the reference keeps in common/Transpose.h,
common/Ordering.h and common/Util.h.  scipy.sparse does the heavy pointer
work on the host; nothing here ever touches a device.

The port's own copy of ``parsy_bench_tpu/core/csc.py`` (the reference);
only the package in its imports differs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp

IDX = np.int32


@dataclasses.dataclass
class CSC:
    """Compressed sparse column matrix (0-based, sorted row indices).

    For symmetric SPD inputs we store only the **lower half** (i >= j), the
    same storage contract as the reference drivers (common/Util.h:77
    ``readMatrix`` reads MatrixMarket lower-half into this form).
    """

    n: int
    indptr: np.ndarray   # (n+1,) int32
    indices: np.ndarray  # (nnz,) int32, sorted within each column
    data: np.ndarray     # (nnz,) float
    #: optional node coordinates (n, d) — synthetic grid generators provide
    #: them so geometric nested dissection can be used as the ordering.
    coords: Optional[np.ndarray] = None

    # ------------------------------------------------------------------ basic
    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    def copy(self) -> "CSC":
        return CSC(self.n, self.indptr.copy(), self.indices.copy(),
                   self.data.copy(),
                   None if self.coords is None else self.coords.copy())

    def __repr__(self) -> str:  # pragma: no cover
        return f"CSC(n={self.n}, nnz={self.nnz})"

    # ----------------------------------------------------------- conversions
    def to_scipy(self) -> sp.csc_matrix:
        return sp.csc_matrix((self.data, self.indices, self.indptr),
                             shape=(self.n, self.n))

    @classmethod
    def from_scipy(cls, m, coords: Optional[np.ndarray] = None) -> "CSC":
        m = sp.csc_matrix(m)
        m.sort_indices()
        if m.shape[0] != m.shape[1]:
            raise ValueError(f"square matrix required, got {m.shape}")
        return cls(m.shape[0], m.indptr.astype(IDX), m.indices.astype(IDX),
                   np.asarray(m.data), coords)

    def to_dense(self) -> np.ndarray:
        return self.to_scipy().toarray()

    # ------------------------------------------------------------ structure
    def is_lower(self) -> bool:
        col = np.repeat(np.arange(self.n, dtype=IDX),
                        np.diff(self.indptr))
        return bool(np.all(self.indices >= col))

    def lower_half(self) -> "CSC":
        """Keep entries with i >= j (reference: computeLowerTriangular,
        common/Util.h:364)."""
        return CSC.from_scipy(sp.tril(self.to_scipy(), 0).tocsc(), self.coords)

    def symmetrize_from_lower(self) -> "CSC":
        """Full symmetric matrix from lower-half storage (L + L^T - diag)."""
        m = self.to_scipy()
        d = sp.diags(m.diagonal())
        return CSC.from_scipy((m + m.T - d).tocsc(), self.coords)

    def transpose(self) -> "CSC":
        """Reference: ``transpose`` / ``ptranspose`` (common/Transpose.h:554)."""
        return CSC.from_scipy(self.to_scipy().T.tocsc(), self.coords)

    def permute(self, perm: np.ndarray) -> "CSC":
        """Symmetric permutation A(p, p) where ``perm`` maps new -> old
        (reference: ``permute`` common/Ordering.h:8 and the double
        ``ptranspose`` in choleskyTest01.cpp:190-191).

        For lower-half inputs the permuted matrix is re-projected onto the
        lower triangle of the full symmetric operator.
        """
        perm = np.asarray(perm, dtype=np.int64)
        inv = np.empty(self.n, dtype=np.int64)
        inv[perm] = np.arange(self.n)
        was_lower = self.is_lower()
        full = self.symmetrize_from_lower() if was_lower else self
        # O(nnz) entry remap (scipy fancy indexing is quadratic here)
        coo = full.to_scipy().tocoo()
        m = sp.csc_matrix((coo.data, (inv[coo.row], inv[coo.col])),
                          shape=(self.n, self.n))
        out = CSC.from_scipy(sp.tril(m, 0).tocsc() if was_lower else m)
        if self.coords is not None:
            out.coords = self.coords[perm]
        return out

    # ------------------------------------------------------------- numerics
    def matvec(self, x: np.ndarray) -> np.ndarray:
        """y = A x; lower-half storage is treated as the symmetric operator."""
        m = (self.symmetrize_from_lower() if self.is_lower() else self)
        return m.to_scipy() @ x

    def spd_rhs_for_ones(self) -> np.ndarray:
        """b = A @ 1 so that x == 1 is the exact solution (reference:
        ``rhsInit`` common/Util.h:261)."""
        return self.matvec(np.ones(self.n))


def rhs_init_trisolve(L: CSC) -> np.ndarray:
    """b = L @ 1 for lower-triangular L, making x == 1 exact (reference:
    ``rhsInitBlocked`` common/Util.h:277)."""
    return L.to_scipy() @ np.ones(L.n)


def check_triangular(x: np.ndarray, tol: float = 1e-3) -> bool:
    """Reference: ``testTriangular`` common/Util.h:294 — all |1 - x_i| < tol."""
    return bool(np.all(np.abs(1.0 - x) < tol))
