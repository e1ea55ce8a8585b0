"""End-to-end solver: analyze -> factorize -> solve, in PyTorch.

Counterpart of ``parsy_bench_tpu/models/solver.py`` (``CholeskySolver``,
supernodal tier).  ``analyze`` is the port's own copy of the JAX
package's host inspector (ordering, etree, column counts, supernodes,
``symbolic/splan.py``); ``factorize`` and ``solve`` run on the card unless
the caller asks for another device (``device="cpu"``).  Arrays in and out
of the public methods are numpy.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from parsy_bench_tpu_torch.config import SolverConfig
from parsy_bench_tpu_torch.core.csc import CSC
from parsy_bench_tpu_torch.symbolic.colcounts import (col_counts,
                                                      symbolic_pattern)
from parsy_bench_tpu_torch.symbolic.etree import etree, postorder
from parsy_bench_tpu_torch.symbolic.ordering import compute_ordering
from parsy_bench_tpu_torch.ops.supernodal import (SupernodalExecutor,
                                                  resolve_device)
from parsy_bench_tpu_torch.symbolic.splan import build_supernodal_plan


class NotPositiveDefiniteError(RuntimeError):
    """The numeric factorization hit a non-positive pivot.

    The reference treats dpotrf info != 0 as an abort
    (parallel_PB_Cholesky_05.h:206-207); here a failed pivot surfaces as
    NaN in the panel pools, detected by one device-side isfinite reduction
    after ``factorize``."""


class CholeskySolver:
    """Sparse SPD solver: A x = b via L L^T with fill-reducing ordering.

    >>> s = CholeskySolver(a, SolverConfig(tier="supernodal")).factorize()
    >>> x = s.solve(b)

    ``device`` defaults to ``"cuda"`` (raises where CUDA is unavailable);
    pass ``device="cpu"`` for the plain versions of the kernels.
    ``fused_finalize`` (off by default) finalizes the classes of width
    <= 64 with one fused kernel per bucket (``SupernodalExecutor``).
    """

    def __init__(self, a: CSC, config: SolverConfig | None = None, *,
                 device="cuda", fused_finalize: bool = False):
        self.device = resolve_device(device)
        self.config = config or SolverConfig()
        if self.config.tier != "supernodal":
            raise NotImplementedError(
                f"tier={self.config.tier!r}: the port runs the supernodal "
                f"tier only; SimplicialExecutor is a later port (ROADMAP "
                f"'Modules to port', SimplicialExecutor)")
        if self.config.verify:
            raise NotImplementedError(
                "verify=True: symbolic/verify.py is a later port (ROADMAP "
                "'Modules to port', symbolic/verify.py)")
        if not a.is_lower():
            a = a.lower_half()
        self.a = a
        #: per-stage inspector wall times
        self.timings: dict = {}
        t0 = time.perf_counter()

        def _mark(key):
            nonlocal t0
            now = time.perf_counter()
            self.timings[key] = round(now - t0, 3)
            t0 = now
        # fill-reducing ordering composed with a weighted postorder of the
        # etree, so supernode columns are contiguous
        fill_perm = compute_ordering(a, self.config.ordering,
                                     self.config.given_perm)
        _mark("ordering_s")
        ap1 = a.permute(fill_perm)
        parent1 = etree(ap1)
        cc1 = col_counts(ap1, parent1)
        post = postorder(parent1, weights=cc1)
        self.perm = fill_perm[post]
        self.ap = ap1.permute(post)
        self.parent = etree(self.ap)
        self.cc = col_counts(self.ap, self.parent)
        _mark("etree_s")
        # the simplicial pattern is lazy: only verification paths
        # (factor_residual / factor_csc) materialize nnz(L) indices
        self._lpat = None
        self.plan = build_supernodal_plan(self.ap, self.parent, self.cc,
                                          None, self.config)
        _mark("plan_s")
        self.executor = SupernodalExecutor(self.plan, self.config.dtype,
                                           self.device,
                                           fused_finalize=fused_finalize)
        _mark("executor_init_s")
        self.lx = None
        self._spd_ok = None
        # scatter helper: x[perm[r]] = xp[r]
        self._inv = np.empty(a.n, dtype=np.int64)
        self._inv[self.perm] = np.arange(a.n)

    @property
    def lpat(self):
        """Simplicial L pattern (csc), materialized on first use."""
        if self._lpat is None:
            t0 = time.perf_counter()
            self._lpat = symbolic_pattern(self.ap, self.parent)
            self.timings["pattern_s"] = round(time.perf_counter() - t0, 3)
        return self._lpat

    # ------------------------------------------------------------ numeric
    def factorize(self, a: CSC | None = None,
                  check_spd: bool = True) -> "CholeskySolver":
        """Numeric factorization; ``a`` may carry new values on the same
        pattern (the inspector is reused).  ``check_spd`` (default):
        raise :class:`NotPositiveDefiniteError` when a pivot was not
        positive (one device-side reduction, one scalar fetch)."""
        data = self.ap.data if a is None else a.permute(self.perm).data
        self.lx = self.executor.factorize(data)
        self._spd_ok = None
        if check_spd and not self.factor_ok():
            raise NotPositiveDefiniteError(
                "matrix is not positive definite (non-positive pivot "
                "during numeric factorization)")
        return self

    def solve(self, b: np.ndarray) -> np.ndarray:
        """x = A^{-1} b (factorize() must have run), with
        ``config.refine_steps`` sweeps of iterative refinement."""
        if self.lx is None:
            raise RuntimeError("call factorize() first")
        b = np.asarray(b)
        x = self._solve_perm(b)
        for _ in range(self.config.refine_steps):
            x = x + self._solve_perm(b - self.a.matvec(x))
        return x

    def _solve_perm(self, b: np.ndarray) -> np.ndarray:
        xp = self.executor.solve_spd(self.lx, b[self.perm])
        return xp.cpu().numpy()[self._inv]

    def _l_values(self) -> np.ndarray:
        if self.lx is None:
            raise RuntimeError("call factorize() first")
        return (self.executor.factor_values(self.lx).cpu().numpy()
                .astype(np.float64))

    # ----------------------------------------------------------- checking
    def factor_residual(self) -> float:
        """|| L L^T - A(p,p) ||_F / || A ||_F (reference: CHOLMOD
        elementwise comparison, choleskyTest01.cpp:529-546)."""
        import scipy.sparse as sp
        lx = self._l_values()
        l = sp.csc_matrix((lx, self.lpat.indices, self.lpat.indptr),
                          shape=(self.a.n, self.a.n))
        full = self.ap.symmetrize_from_lower().to_scipy()
        diff = (l @ l.T - full)
        denom = sp.linalg.norm(full)
        return float(sp.linalg.norm(diff) / denom)

    def solve_residual(self, b: np.ndarray, x: np.ndarray) -> float:
        r = b - self.a.matvec(x)
        return float(np.linalg.norm(r) / max(np.linalg.norm(b), 1e-30))

    def factor_ok(self) -> bool:
        """False when a pivot failed: the NaN it leaves in the pools is
        found by one isfinite reduction on the device.  Cached per
        factorization."""
        if self.lx is None:
            raise RuntimeError("call factorize() first")
        if self._spd_ok is None:
            self._spd_ok = bool(torch.stack(
                [torch.isfinite(p).all() for p in self.lx]).all())
        return self._spd_ok

    def factor_csc(self) -> CSC:
        """The numeric factor L (permuted ordering) as a host CSC."""
        return CSC(self.a.n, self.lpat.indptr.astype(np.int32),
                   self.lpat.indices.astype(np.int32), self._l_values())
