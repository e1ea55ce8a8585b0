"""Level-scheduled simplicial executor (the correctness tier) in PyTorch.

Counterpart of ``parsy_bench_tpu/ops/simplicial.py`` on the same
``SimplicialPlan`` (``parsy_bench_tpu_torch/symbolic/plan.py``):

* factorize — left-looking Cholesky over the wavefront levels (reference:
  cholesky_left_01, cholesky/sereial_Cholesky_01.h:13, and its
  wavefront-parallel schedule, Parallel_PB_Cholesky_wavefront.h:35);
* solve_lower — level-set parallel L x = b (reference: lsolve / lsolvePar,
  triangularSolve/Triangular_CSC.h:14,50: the ``omp atomic`` scatter is an
  ``index_add_``);
* solve_upper — L^T x = b by the same schedule reversed; solve_spd — both.

Levels are grouped into the JAX executor's segments (``segment_levels``):
each segment's per-level index tables are padded to the segment maximum
and stacked, one row per level.  Where JAX runs one ``lax.scan`` per
segment, a Python loop runs the levels here.  Every padded table entry
points at one extra "dummy" slot at the end of the value vector (position
nnz of the factor values, n of a solution vector), so no step masks.

Each entry point runs as one captured program (``ops/graphs.py``: the
counterpart of the JAX ``jax.jit`` closures) over static tensors: the
inputs are copied in outside the program and the results leave as clones.
The translations: ``.at[].add`` is ``index_add_`` (atomic on the card, so
sums may differ from JAX's in their order), ``.at[].set`` is
``index_copy_`` (only the dummy slot repeats in an index), and clearing a
dummy slot is a fill on a one-element view (a capture refuses a copy of a
host scalar).

``segment_levels`` is also used by the supernodal inspector
(``symbolic/splan.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from parsy_bench_tpu_torch.ops import graphs
from parsy_bench_tpu_torch.ops.device import (require, resolve_device,
                                              torch_dtype)
from parsy_bench_tpu_torch.symbolic.plan import SimplicialPlan

#: close a scan segment when padding would exceed this multiple of true work
_PAD_ALPHA = 1.25
#: fixed per-level slack so tiny neighbouring levels coalesce freely
_PAD_SLACK = 64.0


def segment_levels(counts: np.ndarray, alpha: float = _PAD_ALPHA,
                   slack: float = _PAD_SLACK) -> list[tuple[int, int]]:
    """Split the level sequence into contiguous runs [(t0, t1), ...).

    ``counts`` is (nlev, k) per-level work sizes.  A run is closed when
    padding everything in it to the running maxima would exceed
    ``_PAD_ALPHA * true + _PAD_SLACK * len`` — wavefront level sizes decay
    roughly monotonically, so runs coalesce the long tail of tiny levels.
    """
    counts = np.atleast_2d(np.asarray(counts, dtype=np.float64))
    nlev = counts.shape[0]
    segs: list[tuple[int, int]] = []
    t0 = 0
    while t0 < nlev:
        t1 = t0 + 1
        run_max = counts[t0].copy()
        run_sum = float(counts[t0].sum())
        while t1 < nlev:
            new_max = np.maximum(run_max, counts[t1])
            new_sum = run_sum + float(counts[t1].sum())
            padded = float(new_max.sum()) * (t1 - t0 + 1)
            if padded > alpha * new_sum + slack * (t1 - t0 + 1):
                break
            run_max, run_sum = new_max, new_sum
            t1 += 1
        segs.append((t0, t1))
        t0 = t1
    return segs


def _pad_stack(flat: np.ndarray, offsets: np.ndarray, t0: int, t1: int,
               width: int, fill: int) -> np.ndarray:
    """Stack flat[offsets[t]:offsets[t+1]] for t in [t0, t1) into a
    (t1-t0, width) int32 array padded with ``fill``."""
    out = np.full((t1 - t0, width), fill, dtype=np.int32)
    for r, t in enumerate(range(t0, t1)):
        s, e = int(offsets[t]), int(offsets[t + 1])
        out[r, :e - s] = flat[s:e]
    return out


@dataclasses.dataclass
class _Segment:
    """Device-resident padded index tables for one run of levels.  The
    targets of ``index_copy_`` are int64 (it takes no other), the rest
    int32."""
    nsteps: int
    diag: torch.Tensor      # (T, C) positions of diagonals;  pad nnz; int64
    cols: torch.Tensor      # (T, C) column ids;              pad n;   int64
    off_idx: torch.Tensor   # (T, O) off-diag positions;      pad nnz; int64
    off_row: torch.Tensor   # (T, O) global rows;             pad n
    off_lcol: torch.Tensor  # (T, O) col index within level;  pad 0
    #: (T, O) ``off_lcol``, but C on padded entries: the backward solve's
    #: per-level sums put those in a slot of their own
    off_lsafe: torch.Tensor
    upd_a: torch.Tensor     # (T, U) L[i,k] positions;        pad nnz
    upd_b: torch.Tensor     # (T, U) L[j,k] positions;        pad nnz
    upd_dst: torch.Tensor   # (T, U) L[i,j] positions;        pad nnz


class SimplicialExecutor(graphs.ProgramHost):
    """Numeric phase for one ``SimplicialPlan`` on one device: the card
    unless the caller passes ``device="cpu"``.  ``dtype`` is the working
    precision (float32 or float64)."""

    def __init__(self, plan: SimplicialPlan, dtype="float32",
                 device="cuda"):
        self.plan = plan
        self.dtype = torch_dtype(dtype)
        self.device = resolve_device(device)
        p = plan
        n, nnz = int(p.n), int(p.nnz)
        # positions and ids, dummy slots included, must fit int32 (the
        # plan's tables are int32)
        require(nnz + 1 < 2**31 and n + 1 < 2**31,
                f"nnz(L) {nnz} or n {n} overflows int32")
        for name, arr, hi in (("diag", p.diag, nnz), ("cols", p.cols, n),
                              ("off_idx", p.off_idx, nnz),
                              ("off_row", p.off_row, n),
                              ("upd_a", p.upd_a, nnz), ("upd_b", p.upd_b, nnz),
                              ("upd_dst", p.upd_dst, nnz),
                              ("a_map", p.a_map, nnz)):
            require(len(arr) == 0 or (int(arr.min()) >= 0
                                      and int(arr.max()) < hi),
                    f"{name} outside [0, {hi})")
        ccnt = np.diff(p.col_off)
        ocnt = np.diff(p.off_off)
        ucnt = np.diff(p.upd_off)
        require(np.all((p.off_lcol >= 0)
                       & (p.off_lcol < np.repeat(ccnt, ocnt))),
                "off_lcol outside its level")
        self._segs: list[_Segment] = []
        for (t0, t1) in segment_levels(np.stack([ccnt, ocnt, ucnt], axis=1)):
            cw = int(ccnt[t0:t1].max(initial=0))
            ow = int(ocnt[t0:t1].max(initial=0))
            uw = int(ucnt[t0:t1].max(initial=0))
            off_idx = _pad_stack(p.off_idx, p.off_off, t0, t1, ow, nnz)
            off_lcol = _pad_stack(p.off_lcol, p.off_off, t0, t1, ow, 0)
            self._segs.append(_Segment(
                nsteps=t1 - t0,
                diag=self._up(_pad_stack(p.diag, p.col_off, t0, t1, cw, nnz),
                              torch.int64),
                cols=self._up(_pad_stack(p.cols, p.col_off, t0, t1, cw, n),
                              torch.int64),
                off_idx=self._up(off_idx, torch.int64),
                off_row=self._up(
                    _pad_stack(p.off_row, p.off_off, t0, t1, ow, n)),
                off_lcol=self._up(off_lcol),
                off_lsafe=self._up(np.where(off_idx == nnz, cw, off_lcol)),
                upd_a=self._up(_pad_stack(p.upd_a, p.upd_off, t0, t1, uw,
                                          nnz)),
                upd_b=self._up(_pad_stack(p.upd_b, p.upd_off, t0, t1, uw,
                                          nnz)),
                upd_dst=self._up(_pad_stack(p.upd_dst, p.upd_off, t0, t1, uw,
                                            nnz))))
        self._a_map = self._up(p.a_map)
        # the static tensors of the programs, allocated once, outside any
        # capture: A in, the factor values being factored (dummy at nnz),
        # the factor values the solves read (dummy at nnz, kept zero), b,
        # the solution and right-hand-side carries (dummy at n), x out
        dev, dt = self.device, self.dtype
        self._a_in = torch.zeros(len(p.a_map), dtype=dt, device=dev)
        self._lx = torch.zeros(nnz + 1, dtype=dt, device=dev)
        self._lxp = torch.zeros(nnz + 1, dtype=dt, device=dev)
        self._b_in = torch.zeros(n, dtype=dt, device=dev)
        self._x = torch.zeros(n + 1, dtype=dt, device=dev)
        self._bc = torch.zeros(n + 1, dtype=dt, device=dev)
        self._x_out = torch.zeros(n, dtype=dt, device=dev)
        self._init_programs(dev)

    @property
    def num_segments(self) -> int:
        return len(self._segs)

    @property
    def nsteps(self) -> int:
        """Level steps of one factorize or solve (the plan's levels)."""
        return sum(sg.nsteps for sg in self._segs)

    # ------------------------------------------------------------- factor
    def _factorize_impl(self):
        """The A values scattered into the zeroed factor values, then
        every level: scale the level's columns, apply their updates."""
        nnz = self.plan.nnz
        lx = self._lx
        lx.zero_()
        lx.index_add_(0, self._a_map, self._a_in)
        for sg in self._segs:
            for t in range(sg.nsteps):
                s = torch.sqrt(lx.index_select(0, sg.diag[t]))
                lx.index_copy_(0, sg.diag[t], s)
                if sg.off_idx.shape[1]:
                    vals = (lx.index_select(0, sg.off_idx[t])
                            / s.index_select(0, sg.off_lcol[t]))
                    lx.index_copy_(0, sg.off_idx[t], vals)
                if sg.upd_a.shape[1]:
                    upd = (lx.index_select(0, sg.upd_a[t])
                           * lx.index_select(0, sg.upd_b[t]))
                    lx.index_add_(0, sg.upd_dst[t], upd, alpha=-1)
                lx[nnz:].zero_()

    def factorize(self, a_data) -> torch.Tensor:
        """Numeric Cholesky: A values (in the plan's CSC order; numpy or a
        tensor) -> L values (nnz,) on the executor's device.  One program;
        the values it leaves are returned as a clone."""
        a = torch.as_tensor(a_data)
        if a.shape != self._a_in.shape:
            raise ValueError(f"expected {self._a_in.shape[0]} A values, got "
                             f"{tuple(a.shape)}")
        self._a_in.copy_(a)
        self._program("factorize", self._factorize_impl).run()
        return self._lx[:self.plan.nnz].clone()

    # ------------------------------------------------------------- solves
    def _solve_lower_impl(self, b, x):
        """x[:n] = L^{-1} b over the levels; ``x`` and ``self._bc`` carry
        the dummy slot n."""
        n = self.plan.n
        lxp, bc = self._lxp, self._bc
        x.zero_()
        bc[:n].copy_(b)
        bc[n:].zero_()
        for sg in self._segs:
            for t in range(sg.nsteps):
                xt = (bc.index_select(0, sg.cols[t])
                      / lxp.index_select(0, sg.diag[t]))
                x.index_copy_(0, sg.cols[t], xt)
                if sg.off_idx.shape[1]:
                    contrib = (lxp.index_select(0, sg.off_idx[t])
                               * xt.index_select(0, sg.off_lcol[t]))
                    bc.index_add_(0, sg.off_row[t], contrib, alpha=-1)
                x[n:].zero_()
                bc[n:].zero_()
        return x[:n]

    def _solve_upper_impl(self, b, x):
        """x[:n] = L^{-T} b: the levels in reverse, each column's
        off-diagonal products summed per level (padded entries into slot C
        of the sums, which no column reads); ``self._bc`` carries b with
        the dummy slot n.  ``b`` may be a view of ``x``."""
        n = self.plan.n
        lxp, bp = self._lxp, self._bc
        bp[:n].copy_(b)
        bp[n:].zero_()
        x.zero_()
        for sg in reversed(self._segs):
            cw = sg.cols.shape[1]
            for t in reversed(range(sg.nsteps)):
                rhs = bp.index_select(0, sg.cols[t])
                if sg.off_idx.shape[1]:
                    contrib = (lxp.index_select(0, sg.off_idx[t])
                               * x.index_select(0, sg.off_row[t]))
                    s = torch.zeros(cw + 1, dtype=self.dtype,
                                    device=self.device)
                    s.index_add_(0, sg.off_lsafe[t], contrib)
                    rhs = rhs - s[:cw]
                x.index_copy_(0, sg.cols[t],
                              rhs / lxp.index_select(0, sg.diag[t]))
                x[n:].zero_()
        return x[:n]

    def _load_lx(self, lx):
        self._load("lx", (self._lxp[:self.plan.nnz],), (lx,))

    def _solve(self, name, lx, b) -> torch.Tensor:
        """Run the solve program ``name`` on ``lx`` and ``b`` (copied into
        the static tensors unless they hold them) and return a clone of
        its x."""
        self._load_lx(lx)
        b = torch.as_tensor(b)
        if b.shape != (self.plan.n,):
            raise ValueError(f"expected a vector of {self.plan.n}, got "
                             f"{tuple(b.shape)}")
        self._b_in.copy_(b)
        bv, x = self._b_in, self._x
        impl = {
            "solve_lower": lambda: self._solve_lower_impl(bv, x),
            "solve_upper": lambda: self._solve_upper_impl(bv, x),
            "solve_spd": lambda: self._solve_upper_impl(
                self._solve_lower_impl(bv, x), x),
        }[name]
        self._program(name, lambda: self._x_out.copy_(impl())).run()
        return self._x_out.clone()

    def solve_lower(self, lx, b) -> torch.Tensor:
        """x = L^{-1} b (forward substitution, level-parallel)."""
        return self._solve("solve_lower", lx, b)

    def solve_upper(self, lx, b) -> torch.Tensor:
        """x = L^{-T} b (backward substitution, level-parallel)."""
        return self._solve("solve_upper", lx, b)

    def solve_spd(self, lx, b) -> torch.Tensor:
        """x = A^{-1} b given the factor values (two triangular solves)."""
        return self._solve("solve_spd", lx, b)

    # ------------------------------------------------------------ exports
    def factor_csc(self, lx) -> np.ndarray:
        """Host copy of L values (in plan CSC order)."""
        return torch.as_tensor(lx).cpu().numpy()
