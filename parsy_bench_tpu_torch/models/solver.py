"""End-to-end solvers: analyze -> factorize -> solve, in PyTorch.

Counterpart of ``parsy_bench_tpu/models/solver.py``: ``CholeskySolver``
(supernodal and simplicial tiers), ``TriangularSolver`` (a given
lower-triangular L, at both tiers, with the wavefront, coarsened and
"auto" schedules) and the two pruned solvers.  ``analyze`` is the port's
own copy of the JAX package's host inspector (ordering, etree, column
counts, supernodes, ``symbolic/{splan,plan,strisolve,dagplan}.py``);
``factorize`` and ``solve`` run on the card unless the caller asks for
another device (``device="cpu"``).  Arrays in and out of the public
methods are numpy.
"""
from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from parsy_bench_tpu_torch.config import SolverConfig
from parsy_bench_tpu_torch.core.csc import CSC
from parsy_bench_tpu_torch.core.io import load_artifact, save_artifact
from parsy_bench_tpu_torch.symbolic.colcounts import (col_counts,
                                                      symbolic_pattern)
from parsy_bench_tpu_torch.symbolic.etree import (etree, postorder,
                                                  tree_levels)
from parsy_bench_tpu_torch.symbolic.ordering import compute_ordering
from parsy_bench_tpu_torch.ops.residual import SymmetricResidual
from parsy_bench_tpu_torch.ops.simplicial import SimplicialExecutor
from parsy_bench_tpu_torch.ops.supernodal import (SupernodalExecutor,
                                                  resolve_device)
from parsy_bench_tpu_torch.ops.trace import span
from parsy_bench_tpu_torch.symbolic.plan import dag_levels, plan_from_pattern
from parsy_bench_tpu_torch.symbolic.splan import build_supernodal_plan
from parsy_bench_tpu_torch.symbolic.verify import verify_plan


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
    <= 64 with one fused kernel per bucket (``SupernodalExecutor``; the
    simplicial tier has no finalize and refuses it).  ``config.verify``
    checks the supernodal plan with ``symbolic/verify.verify_plan`` before
    the executor is built (``timings["verify_s"]``).
    """

    def __init__(self, a: CSC, config: SolverConfig | None = None, *,
                 device="cuda", fused_finalize: bool = False):
        """Analyze ``a``'s pattern (its lower half when ``a`` is not
        lower-half).  Besides the ordering and the plan, the analysis fixes
        the value map: where each entry of the permuted matrix ``self.ap``
        lies in ``a.data``, kept on the device.  ``a`` may not store an
        entry twice (``ValueError``).  A later ``factorize(a)`` must carry
        this pattern; its values are gathered on the device by the map."""
        self.device = resolve_device(device)
        self.config = config or SolverConfig()
        if self.config.tier not in ("supernodal", "simplicial"):
            raise ValueError(f"tier={self.config.tier!r}: supernodal or "
                             f"simplicial")
        if fused_finalize and self.config.tier != "supernodal":
            raise ValueError("fused_finalize needs tier='supernodal'")
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
        ap1 = _entry_ids(a).permute(fill_perm)
        parent1 = etree(ap1)
        cc1 = col_counts(ap1, parent1)
        post = postorder(parent1, weights=cc1)
        self.perm = fill_perm[post]
        self._set_value_map(ap1.permute(post))
        self.parent = etree(self.ap)
        self.cc = col_counts(self.ap, self.parent)
        _mark("etree_s")
        # the simplicial pattern is lazy for the supernodal tier: only
        # verification paths (factor_residual / factor_csc) materialize
        # nnz(L) indices
        self._lpat = None
        if self.config.tier == "supernodal":
            self.plan = build_supernodal_plan(self.ap, self.parent, self.cc,
                                              None, self.config)
            _mark("plan_s")
            if self.config.verify:
                verify_plan(self.plan)
                _mark("verify_s")
            self.executor = SupernodalExecutor(
                self.plan, self.config.dtype, self.device,
                fused_finalize=fused_finalize)
        else:
            self.plan = plan_from_pattern(self.lpat, tree_levels(self.parent),
                                          a=self.ap, with_updates=True)
            _mark("plan_s")
            self.executor = SimplicialExecutor(self.plan, self.config.dtype,
                                               self.device)
        self._vmap_dev = self._vmap_dev.to(self.device)
        _mark("executor_init_s")
        self._init_numeric()

    def _init_numeric(self) -> None:
        """The state of the numeric phase, before any ``factorize``."""
        self.lx = None
        self._spd_ok = None
        #: with refinement: the latest factorize's A values in ``self.ap``'s
        #: order, float64 on the device, and the residual's operator
        self._a64 = None
        self._residual = None
        #: the refinement sweeps the last ``solve`` ran
        self.refine_sweeps = 0
        # scatter helper: x[perm[r]] = xp[r]
        self._inv = np.empty(self.a.n, dtype=np.int64)
        self._inv[self.perm] = np.arange(self.a.n)

    def _set_value_map(self, ap_ids: CSC) -> None:
        """``self.ap`` and the value map from the analysed pattern's entry
        ids (``_entry_ids``) permuted as ``self.perm`` permutes ``self.a``:
        ``self.a.permute(self.perm).data == self.a.data[vmap]``.  The map
        (``_vmap_dev``, int32) goes to the device once the executor has
        checked it; ``factorize(a)`` gathers ``a``'s values with it there.
        An entry stored twice would sum two ids into one: the map is then
        no permutation of ``0..nnz-1``, and a ``ValueError`` says so."""
        nnz = self.a.nnz
        vmap = ap_ids.data.astype(np.int64) - 1
        if (len(vmap) != nnz
                or not np.all(np.bincount(vmap, minlength=nnz) == 1)):
            raise ValueError("a stores an entry twice: duplicate (row, col) "
                             "entries are not canonical CSC input")
        self.ap = CSC(ap_ids.n, ap_ids.indptr, ap_ids.indices,
                      self.a.data[vmap], ap_ids.coords)
        self._vmap_dev = torch.from_numpy(vmap.astype(np.int32))

    def _gather_values(self, a: CSC, dtype):
        """``a``'s values in ``self.ap``'s order, as ``dtype``: ``a.data``
        copied to the device as it is, then one gather by the map fixed at
        analysis.
        ``a`` must carry the analysed pattern, the very arrays or equal
        ones; an ``a`` that is not lower-half is first cut to its lower
        half, as ``__init__`` cuts it.  Any other pattern raises
        ``ValueError``."""
        same = self._is_analysed_pattern(a)
        if not same and not a.is_lower():
            a = a.lower_half()
            same = self._is_analysed_pattern(a)
        if not same:
            raise ValueError("a's pattern is not the analysed one "
                             f"(n={self.a.n}, nnz={self.a.nnz})")
        if len(a.data) != len(self._vmap_dev):
            raise ValueError(f"expected {len(self._vmap_dev)} A values, got "
                             f"{len(a.data)}")
        vals = torch.as_tensor(np.ascontiguousarray(a.data)).to(
            device=self.device, dtype=dtype)
        return vals.index_select(0, self._vmap_dev)

    def _is_analysed_pattern(self, a: CSC) -> bool:
        pa = self.a
        return ((a.indptr is pa.indptr and a.indices is pa.indices)
                or (np.array_equal(a.indptr, pa.indptr)
                    and np.array_equal(a.indices, pa.indices)))

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
        """Numeric factorization; ``a`` may carry new values on the
        analysed pattern (the inspector is reused): its ``indptr`` and
        ``indices`` (those of its lower half, when ``a`` is not
        lower-half) must be the analysed ones, the very arrays or equal
        ones, else ``ValueError``.  ``a.data`` goes to the device in its
        own order and is gathered there into the factor's order by a map
        fixed at analysis; with no ``a`` the analysed values are used.  It
        runs the executor's captured ``factorize`` program; ``self.lx``
        holds the pools (the simplicial tier: the L values) that no later
        factorize overwrites.  With ``config.refine_steps`` the values go
        to the device in float64 and stay there in the factor's order
        (``solve``'s residuals use them); the executor's load casts them to
        its dtype.  ``check_spd`` (default): raise
        :class:`NotPositiveDefiniteError` when a pivot was not positive
        (one device-side reduction, one scalar fetch).  Under a profiler
        it shows as the span ``solver.factorize`` around
        ``solver.permute_values`` (the pattern check, the copy of
        ``a.data`` to the device and the gather), the executor's spans
        (``executor.load`` then copies device to device) and
        ``solver.spd_check``."""
        with span("solver.factorize"):
            with span("solver.permute_values"):
                if not self.config.refine_steps:
                    self._a64 = None
                    data = (self.ap.data if a is None
                            else self._gather_values(a, self.executor.dtype))
                else:
                    self._a64 = data = (
                        torch.as_tensor(self.ap.data, dtype=torch.float64,
                                        device=self.device) if a is None
                        else self._gather_values(a, torch.float64))
            self.lx = self.executor.factorize(data)
            self._spd_ok = None
            if check_spd:
                with span("solver.spd_check"):
                    ok = self.factor_ok()
                if not ok:
                    raise NotPositiveDefiniteError(
                        "matrix is not positive definite (non-positive "
                        "pivot during numeric factorization)")
        return self

    def solve(self, b: np.ndarray) -> np.ndarray:
        """x = A^{-1} b (factorize() must have run); each solve with the
        factor runs the executor's captured ``solve_spd`` program.  Under a
        profiler it shows as the span ``solver.solve`` around
        ``solver.permute_rhs``, the executor's spans, ``solver.fetch_x``
        and ``solver.unpermute_x``.

        With ``config.refine_steps`` = k > 0 it is mixed-precision
        iterative refinement against the values of the latest
        ``factorize``, in the factor's order on the device: b is permuted
        once, x = solve_spd(b), then k sweeps (span ``solver.refine``) of
        r = b - A x in float64 (span ``solver.residual``,
        ``ops/residual.SymmetricResidual``) and x += solve_spd(r), the
        solve in the factor's dtype and x kept in float64.  It returns
        float64 (without refinement: the factor's dtype), and
        ``refine_sweeps`` counts the sweeps it ran."""
        if self.lx is None:
            raise RuntimeError("call factorize() first")
        with span("solver.solve"):
            b = np.asarray(b)
            if not self.config.refine_steps:
                self.refine_sweeps = 0
                return self._solve_perm(b)
            return self._solve_refined(b)

    def _solve_perm(self, b: np.ndarray) -> np.ndarray:
        with span("solver.permute_rhs"):
            bp = b[self.perm]
        xp = self.executor.solve_spd(self.lx, bp)
        return self._unpermute(xp)

    def _unpermute(self, xp: torch.Tensor) -> np.ndarray:
        with span("solver.fetch_x"):
            xh = xp.cpu()
        with span("solver.unpermute_x"):
            return xh.numpy()[self._inv]

    def _solve_refined(self, b: np.ndarray) -> np.ndarray:
        if self._a64 is None:
            raise RuntimeError("refinement needs a factorize() with "
                               "refine_steps > 0")
        if self._residual is None:
            self._residual = SymmetricResidual(self.ap.indptr,
                                               self.ap.indices, self.device)
        with span("solver.permute_rhs"):
            bp = torch.as_tensor(np.ascontiguousarray(
                b[self.perm], dtype=np.float64)).to(self.device)
        x = self.executor.solve_spd(self.lx, bp).double()
        self.refine_sweeps = 0
        with span("solver.refine"):
            for _ in range(self.config.refine_steps):
                with span("solver.residual"):
                    r = self._residual(self._a64, bp, x)
                x += self.executor.solve_spd(self.lx, r)
                self.refine_sweeps += 1
        return self._unpermute(x)

    def _l_values(self) -> np.ndarray:
        """Simplicial-pattern L values, whichever tier produced them."""
        if self.lx is None:
            raise RuntimeError("call factorize() first")
        lx = (self.executor.factor_values(self.lx)
              if self.config.tier == "supernodal" else self.lx)
        return lx.cpu().numpy().astype(np.float64)

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
            parts = self.lx if isinstance(self.lx, tuple) else (self.lx,)
            self._spd_ok = bool(torch.stack(
                [torch.isfinite(p).all() for p in parts]).all())
        return self._spd_ok

    def factor_csc(self) -> CSC:
        """The numeric factor L (permuted ordering) as a host CSC."""
        return CSC(self.a.n, self.lpat.indptr.astype(np.int32),
                   self.lpat.indices.astype(np.int32), self._l_values())

    # ------------------------------------------------- analysis caching
    def save_analysis(self, path: str) -> None:
        """Serialize the inspector output (permutation and plan), the
        checkpointable symbolic artifact (the reference's cacheable
        ordering, common/Util.h:187).  The lazy simplicial pattern is
        saved only if it was built."""
        save_artifact(path, {"perm": self.perm, "plan": self.plan,
                             "lpat": self._lpat, "parent": self.parent,
                             "cc": self.cc},
                      meta={"n": self.a.n, "nnz": self.a.nnz,
                            "tier": self.config.tier})

    @classmethod
    def from_artifact(cls, a: CSC, path: str,
                      config: SolverConfig | None = None, *,
                      device="cuda",
                      fused_finalize: bool = False) -> "CholeskySolver":
        """Restore a solver from a saved analysis, skipping the inspector
        (ordering, symbolic, plan); ``a`` must have the pattern the
        analysis was made for (a ``ValueError`` otherwise), and only its
        values are used.  The artifact's tier wins over ``config``'s, with
        a warning.  ``config.verify`` checks the restored plan
        (``timings["verify_s"]``).  An artifact written by the JAX package
        is refused (``core/io.load_artifact``)."""
        obj, meta = load_artifact(path)
        if meta.get("n") != a.n or meta.get("nnz") != a.lower_half().nnz:
            raise ValueError(
                f"artifact is for n={meta.get('n')}/nnz={meta.get('nnz')}, "
                f"matrix has n={a.n}")
        art_tier = meta.get("tier", "supernodal")
        if config is not None and config.tier != art_tier:
            warnings.warn(
                f"artifact was analyzed for tier={art_tier!r}; overriding "
                f"config tier={config.tier!r}", stacklevel=2)
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self.config = (config or SolverConfig()).replace(tier=art_tier)
        if fused_finalize and self.config.tier != "supernodal":
            raise ValueError("fused_finalize needs tier='supernodal'")
        self.a = a if a.is_lower() else a.lower_half()
        self.perm = obj["perm"]
        self._set_value_map(_entry_ids(self.a).permute(self.perm))
        self.parent = obj["parent"]
        self.cc = obj["cc"]
        self._lpat = obj["lpat"]
        self.timings = {}
        self.plan = obj["plan"]
        if self.config.tier == "supernodal":
            if self.config.verify:
                t0 = time.perf_counter()
                verify_plan(self.plan)
                self.timings["verify_s"] = round(time.perf_counter() - t0, 3)
            self.executor = SupernodalExecutor(
                self.plan, self.config.dtype, self.device,
                fused_finalize=fused_finalize)
        else:
            self.executor = SimplicialExecutor(self.plan, self.config.dtype,
                                               self.device)
        self._vmap_dev = self._vmap_dev.to(self.device)
        self._init_numeric()
        return self


def _entry_ids(a: CSC) -> CSC:
    """``a``'s pattern with the entry ids 1..nnz as its values: float64
    holds them exactly, and no id is an exact zero, which symmetrizing in
    ``CSC.permute`` would drop."""
    return CSC(a.n, a.indptr, a.indices,
               np.arange(1, a.nnz + 1, dtype=np.float64), a.coords)


def _pattern(l: CSC):
    """L's pattern as a scipy CSC matrix of ones."""
    import scipy.sparse as sp
    return sp.csc_matrix((np.ones(l.nnz, dtype=np.int8), l.indices,
                          l.indptr), shape=(l.n, l.n))


class TriangularSolver:
    """Level-set parallel solver for a given lower-triangular L (general,
    possibly non-chordal DAG — reference: triangularTest_DAG_nonChordal.cpp
    and lsolvePar, Triangular_CSC.h:50).

    tier="simplicial": scalar level-scheduled executor (any pattern), on
    the schedule ``config.trisolve_schedule``: "wavefront" (one step per
    DAG level), "coarsened" (dense W-column windows, ``ops/dagsolve.py``)
    or "auto" (``symbolic/dagplan.choose_schedule``);
    tier="supernodal": blocked BCSC panels from value-pattern supernode
    detection (reference Inspection_Block.h:7 + Triangular_BCSC.h:171).

    ``device`` defaults to ``"cuda"`` (raises where CUDA is unavailable).
    """

    def __init__(self, l: CSC, config: SolverConfig | None = None, *,
                 device="cuda"):
        self.device = resolve_device(device)
        self.config = config or SolverConfig()
        self.l = l
        if self.config.tier == "supernodal":
            from parsy_bench_tpu_torch.symbolic.strisolve import (
                build_trisolve_plan)
            self.plan = build_trisolve_plan(l, self.config)
            self.executor = SupernodalExecutor(self.plan, self.config.dtype,
                                               self.device)
            # the layout's A map places L's entries straight into the
            # class pools (for a trisolve the input is the factor);
            # prepare_solve_pools stores the diagonal blocks' inverses
            # the solves read from the strict upper triangles
            self._lx = self.executor.prepare_solve_pools(
                self.executor.init_pools(l.data))
            return
        self.levels = dag_levels(_pattern(l))
        sched = self.config.trisolve_schedule
        if sched == "auto":
            from parsy_bench_tpu_torch.symbolic.dagplan import choose_schedule
            sched = choose_schedule(l, self.levels, self.config.coarse_width)
        self.schedule = sched
        if sched == "coarsened":
            from parsy_bench_tpu_torch.ops.dagsolve import (
                CoarseTrisolveExecutor)
            from parsy_bench_tpu_torch.symbolic.dagplan import (
                build_coarse_trisolve)
            self.plan = build_coarse_trisolve(l, self.levels,
                                              self.config.coarse_width)
            self.executor = CoarseTrisolveExecutor(
                self.plan, self.config.dtype, self.device)
        elif sched == "wavefront":
            self.plan = plan_from_pattern(_pattern(l), self.levels, a=None,
                                          with_updates=False)
            self.executor = SimplicialExecutor(self.plan, self.config.dtype,
                                               self.device)
        else:
            raise ValueError(f"trisolve_schedule={sched!r}: wavefront, "
                             f"coarsened or auto")
        self._lx = torch.as_tensor(np.asarray(l.data)).to(
            device=self.device, dtype=self.executor.dtype)

    @property
    def nlev(self) -> int:
        return self.plan.nlev

    def solve(self, b: np.ndarray) -> np.ndarray:
        """x = L^{-1} b (forward substitution, level-parallel)."""
        return self.executor.solve_lower(self._lx, b).cpu().numpy()

    def solve_transposed(self, b: np.ndarray) -> np.ndarray:
        """x = L^{-T} b (backward substitution)."""
        return self.executor.solve_upper(self._lx, b).cpu().numpy()

    def pruned(self, rhs_rows: np.ndarray):
        """Sparse-RHS solver restricted to the reach set of ``rhs_rows``
        (reference: reach + lsolve_reach_dec, common/Reach.h:14 and
        Triangular_CSC.h:225).  The reach is computed once per RHS
        pattern; the returned object solves many numeric RHS with that
        pattern, touching only the active columns.  tier="supernodal"
        returns the blocked pruned solver (blockedPrunedLSolve,
        Triangular_BCSC.h:55)."""
        if self.config.tier == "supernodal":
            return PrunedBlockedTriangularSolve(
                self.l, self.plan, np.asarray(rhs_rows), self.config,
                device=self.device)
        return PrunedTriangularSolve(self.l, np.asarray(rhs_rows),
                                     self.config, device=self.device)


def _submatrix(l: CSC, idx: np.ndarray) -> CSC:
    """L restricted to the rows and columns ``idx`` (ascending), sorted."""
    sub = l.to_scipy()[np.ix_(idx, idx)].tocsc()
    sub.sort_indices()
    return CSC(len(idx), sub.indptr.astype(np.int64),
               sub.indices.astype(np.int64), sub.data)


class PrunedBlockedTriangularSolve:
    """Blocked (BCSC) solve on the supernodal-reach-restricted subset
    (reference: blockedPrunedLSolve, Triangular_BCSC.h:55-109, with the
    reach mapped to supernodes by reach_sn, Reach.h:31).

    The active supernode set is closed under the supernode DAG, so every
    below-diagonal row of an active panel lands in an active column and
    the restricted submatrix keeps the full blocked structure; work is
    proportional to the active panels, not n."""

    def __init__(self, l: CSC, plan, rhs_rows: np.ndarray,
                 config: SolverConfig | None = None, *, device="cuda"):
        from parsy_bench_tpu_torch.symbolic.reach import reach_sn
        from parsy_bench_tpu_torch.symbolic.strisolve import (
            build_trisolve_plan)
        self.device = resolve_device(device)
        self.config = config or SolverConfig()
        lay = plan.layout
        part = lay.part
        self.n = l.n
        self.sn_reach = reach_sn(lay.rptr, lay.rows, part.sptr,
                                 part.col2sup, rhs_rows)
        cols = np.concatenate([
            np.arange(part.sptr[s], part.sptr[s + 1])
            for s in self.sn_reach]) if len(self.sn_reach) else \
            np.zeros(0, dtype=np.int64)
        self.cols = cols.astype(np.int64)
        lsub = _submatrix(l, self.cols)
        self.plan = build_trisolve_plan(lsub, self.config)
        self.executor = SupernodalExecutor(self.plan, self.config.dtype,
                                           self.device)
        self._lx = self.executor.prepare_solve_pools(
            self.executor.init_pools(lsub.data))

    def solve(self, b: np.ndarray) -> np.ndarray:
        """x = L^{-1} b where b is nonzero only on the RHS pattern; work
        is proportional to the active supernodes, not n."""
        xr = self.executor.solve_lower(
            self._lx, np.asarray(b)[self.cols]).cpu().numpy()
        x = np.zeros(self.n, dtype=xr.dtype)
        x[self.cols] = xr
        return x


class PrunedTriangularSolve:
    """Level-scheduled solve on the reach-restricted submatrix."""

    def __init__(self, l: CSC, rhs_rows: np.ndarray,
                 config: SolverConfig | None = None, *, device="cuda"):
        from parsy_bench_tpu_torch.symbolic.reach import reach
        self.device = resolve_device(device)
        self.config = config or SolverConfig()
        self.reach = reach(_pattern(l), rhs_rows)
        self.n = l.n
        sub = _submatrix(l, self.reach)
        lpat = _pattern(sub)
        self.plan = plan_from_pattern(lpat, dag_levels(lpat), a=None,
                                      with_updates=False)
        self.executor = SimplicialExecutor(self.plan, self.config.dtype,
                                           self.device)
        self._lx = torch.as_tensor(np.asarray(sub.data)).to(
            device=self.device, dtype=self.executor.dtype)

    def solve(self, b: np.ndarray) -> np.ndarray:
        """x = L^{-1} b where b is nonzero only on the RHS pattern; work is
        proportional to the reach set, not n."""
        xr = self.executor.solve_lower(
            self._lx, np.asarray(b)[self.reach]).cpu().numpy()
        x = np.zeros(self.n, dtype=xr.dtype)
        x[self.reach] = xr
        return x
