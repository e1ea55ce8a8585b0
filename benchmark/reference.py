"""The plain reference: A x = b for a banded SPD matrix by block Cholesky.

It takes the benchmark's own arrays (the lower half of A in CSC order and
the right-hand sides) and nothing the program made, and it imports nothing
of the program.  It orders nothing: in its natural order a matrix of
half-bandwidth s (every stored entry has ``row - col <= s``) is block
tridiagonal with blocks of s rows, and

    S_0 = A_00;  L_k = chol(S_k);  M_k^T = L_k^{-1} B_k^T;
    S_{k+1} = A_{k+1,k+1} - M_k M_k^T,

with ``B_k = A_{k+1,k}``.  The solve runs forward
(``y_{k+1} = L_{k+1}^{-1} (b_{k+1} - M_k y_k)``, with
``M_k y = B_k L_k^{-T} y``) and backward
(``x_k = L_k^{-T} (y_k - M_k^T x_{k+1})``, with
``M_k^T x = L_k^{-1} B_k^T x``) from the kept ``L_k``; the ``B_k`` are
filled again when needed.  Only the L_k stay: s^2 * K numbers, 2 GB in
float64 for the 3D grid of 48^3 (s = 2,304) and 8 GB for the 2D grid of
1000^2 (s = 1,000).  Dense blocks are filled on the device from the CSC
entries of their columns.

``precision`` is ``"float64"`` (the reference), ``"float32"``, or
``"tf32"``: float32 with TF32 products allowed on the card, the precision
below the configurations' float32 that the program refuses.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

PRECISIONS = ("float64", "float32", "tf32")


def half_bandwidth(indptr, indices) -> int:
    """max(row - col) over the stored lower-half entries."""
    col = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    return int(np.max(indices - col)) if len(col) else 0


@contextlib.contextmanager
def _tf32(on: bool):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


class BandedCholesky:
    """One factorization of one value set; ``solve`` takes any number of
    right-hand sides after it."""

    def __init__(self, indptr, indices, data, device, precision="float64"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
        self.device = torch.device(device)
        self.precision = precision
        self.dtype = torch.float64 if precision == "float64" else torch.float32
        n = len(indptr) - 1
        self.n = n
        self.s = max(1, half_bandwidth(indptr, indices))
        self.bounds = list(range(0, n, self.s)) + [n]
        dev, dt = self.device, self.dtype
        self._indptr = np.asarray(indptr, dtype=np.int64)
        col = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        self._row = torch.as_tensor(np.asarray(indices, np.int64), device=dev)
        self._col = torch.as_tensor(col, device=dev)
        self._val = torch.as_tensor(np.asarray(data), device=dev).to(dt)
        self.L = []
        with _tf32(precision == "tf32"):
            self._factor()

    def _entries(self, k):
        """(row, col, value) of the stored entries in block column k."""
        lo = int(self._indptr[self.bounds[k]])
        hi = int(self._indptr[self.bounds[k + 1]])
        return self._row[lo:hi], self._col[lo:hi], self._val[lo:hi]

    def _diag(self, k):
        """The dense diagonal block A_kk, both halves."""
        r0, r1 = self.bounds[k], self.bounds[k + 1]
        row, col, val = self._entries(k)
        inb = row < r1
        a = torch.zeros((r1 - r0, r1 - r0), dtype=self.dtype,
                        device=self.device)
        a[row[inb] - r0, col[inb] - r0] = val[inb]
        return a + torch.tril(a, -1).T

    def _sub(self, k):
        """The dense block B_k = A_{k+1,k} under diagonal block k."""
        r0, r1, r2 = self.bounds[k:k + 3]
        row, col, val = self._entries(k)
        out = row >= r1
        b = torch.zeros((r2 - r1, r1 - r0), dtype=self.dtype,
                        device=self.device)
        b[row[out] - r1, col[out] - r0] = val[out]
        return b

    def _factor(self):
        K = len(self.bounds) - 1
        S = self._diag(0)
        info = torch.zeros((), dtype=torch.int32, device=self.device)
        for k in range(K):
            L, i = torch.linalg.cholesky_ex(S)
            info = torch.maximum(info, i)
            self.L.append(L)
            if k + 1 < K:
                Mt = torch.linalg.solve_triangular(L, self._sub(k).T,
                                                   upper=False)
                S = self._diag(k + 1) - Mt.T @ Mt
        if int(info) != 0:
            raise ValueError("the reference met a non-positive pivot")

    def solve(self, b) -> np.ndarray:
        """x = A^{-1} b for b of shape (n,) or (n, r), as float64 numpy."""
        b = np.asarray(b)
        one = b.ndim == 1
        with _tf32(self.precision == "tf32"):
            x = self._solve(torch.as_tensor(b.reshape(self.n, -1),
                                            device=self.device).to(self.dtype))
        x = x.double().cpu().numpy()
        return x[:, 0] if one else x

    def _solve(self, b):
        K = len(self.bounds) - 1
        y = []
        for k in range(K):
            r0, r1 = self.bounds[k], self.bounds[k + 1]
            rhs = b[r0:r1]
            if k:
                # M_{k-1} y_{k-1} = B_{k-1} L_{k-1}^{-T} y_{k-1}
                z = torch.linalg.solve_triangular(self.L[k - 1].T, y[k - 1],
                                                  upper=True)
                rhs = rhs - self._sub(k - 1) @ z
            y.append(torch.linalg.solve_triangular(self.L[k], rhs,
                                                   upper=False))
        x = [None] * K
        for k in range(K - 1, -1, -1):
            rhs = y[k]
            if k + 1 < K:
                # M_k^T x_{k+1} = L_k^{-1} B_k^T x_{k+1}
                rhs = rhs - torch.linalg.solve_triangular(
                    self.L[k], self._sub(k).T @ x[k + 1], upper=False)
            x[k] = torch.linalg.solve_triangular(self.L[k].T, rhs,
                                                 upper=True)
        return torch.cat(x)
