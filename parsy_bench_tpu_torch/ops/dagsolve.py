"""Coarsened dense-block triangular-solve executor in PyTorch.

Counterpart of ``parsy_bench_tpu/ops/dagsolve.py`` on the same
``CoarseTrisolvePlan`` (``parsy_bench_tpu_torch/symbolic/dagplan.py``;
reference: ``lsolveParH2`` over the DAG-LBC schedule, Triangular_CSC.h:76
+ InspectionDAG_03.h:14).

One step per W-column window: the window's entries land in a dense
(W, W) lower-triangular block, the inverses of its 16 x 16 diagonal
sub-blocks come from one batched Neumann product (``ops/dense.
nilpotent_inv``), a sub-block forward substitution (W/16 matrix-vector
products) solves the window, and one ``index_add_`` applies the
off-block entries to the right-hand side.  Where JAX runs the windows as
one ``lax.scan``, a Python loop runs them here, inside one captured
program per solve (``ops/graphs.py``) over static tensors.  The products
run in full f32 (TF32 is refused on the card, as in the supernodal
executor).  Padded table entries point at dummy slots: position nnz of the
factor values (kept zero), n of the vectors and W*W of the dense block.
"""
from __future__ import annotations

import numpy as np
import torch

from parsy_bench_tpu_torch.ops import dense, graphs
from parsy_bench_tpu_torch.ops.device import (refuse_tf32, require,
                                              resolve_device, torch_dtype)
from parsy_bench_tpu_torch.symbolic.dagplan import CoarseTrisolvePlan, _SUB


class CoarseTrisolveExecutor(graphs.ProgramHost):
    """Forward and backward substitution for one ``CoarseTrisolvePlan`` on
    one device: the card unless the caller passes ``device="cpu"``."""

    def __init__(self, plan: CoarseTrisolvePlan, dtype="float32",
                 device="cuda"):
        self.plan = plan
        self.dtype = torch_dtype(dtype)
        self.device = resolve_device(device)
        refuse_tf32(self.device)
        n, nnz, W = int(plan.n), int(plan.nnz), int(plan.W)
        require(W % _SUB == 0, f"window {W} not a multiple of {_SUB}")
        require(nnz + 1 < 2**31 and W * W + 1 < 2**31,
                f"nnz(L) {nnz} or the window block overflows int32")
        for name, arr, hi in (("cols", plan.cols, n), ("diag", plan.diag, nnz),
                              ("bpos", plan.bpos, nnz),
                              ("brc", plan.brc, W * W),
                              ("opos", plan.opos, nnz),
                              ("orow", plan.orow, n), ("ocol", plan.ocol, W)):
            require(arr.shape[0] == plan.nsteps
                    and int(arr.min(initial=0)) >= 0
                    and int(arr.max(initial=0)) <= hi,
                    f"{name} outside [0, {hi}]")
        # targets of index_copy_ are int64 (it takes no other)
        self._cols = self._up(plan.cols, torch.int64)
        self._pad = self._up(plan.cols == n, torch.bool)
        self._diag = self._up(plan.diag)
        self._bpos = self._up(plan.bpos)
        self._brc = self._up(plan.brc, torch.int64)
        self._opos = self._up(plan.opos)
        self._orow = self._up(plan.orow)
        self._ocol = self._up(plan.ocol)
        # the static tensors of the programs: the factor values (dummy at
        # nnz, kept zero), b, the x and right-hand-side carries (dummy at
        # n), the window's flat block (dummy at W*W), its solution and
        # off-block sums (dummy at W), x out
        dev, dt = self.device, self.dtype
        self._lxp = torch.zeros(nnz + 1, dtype=dt, device=dev)
        self._b_in = torch.zeros(n, dtype=dt, device=dev)
        self._x = torch.zeros(n + 1, dtype=dt, device=dev)
        self._bc = torch.zeros(n + 1, dtype=dt, device=dev)
        self._flat = torch.zeros(W * W + 1, dtype=dt, device=dev)
        self._xg = torch.zeros(W + 1, dtype=dt, device=dev)
        self._x_out = torch.zeros(n, dtype=dt, device=dev)
        self._init_programs(dev)

    # ------------------------------------------------------------ helpers
    def _dense_block(self, t):
        """Window t's (W, W) block, its diagonal on the diagonal (1 on
        padded columns), and the inverses of its 16 x 16 diagonal
        sub-blocks (nb, 16, 16)."""
        W = self.plan.W
        lxp = self._lxp
        d = lxp.index_select(0, self._diag[t]).masked_fill(self._pad[t], 1.0)
        flat = self._flat
        flat.zero_()
        flat.index_copy_(0, self._brc[t], lxp.index_select(0, self._bpos[t]))
        Ld = flat[:-1].view(W, W)
        Ld.diagonal().add_(d)
        nb = W // _SUB
        dblk = torch.diagonal(Ld.view(nb, _SUB, nb, _SUB), dim1=0,
                              dim2=2).permute(2, 0, 1)
        return Ld, dense.nilpotent_inv(dblk)

    def _solve_window(self, Ld, iL, rhs):
        """xg (a view of the static window solution) with Ld xg = rhs, by
        sub-block forward substitution."""
        W = self.plan.W
        xg = self._xg[:W]
        xg.zero_()
        for b in range(W // _SUB):
            s = b * _SUB
            r = torch.addmv(rhs[s:s + _SUB], Ld[s:s + _SUB, :], xg,
                            alpha=-1)
            torch.mv(iL[b], r, out=xg[s:s + _SUB])
        return xg

    def _solve_window_t(self, Ld, iL, rhs):
        """xg with Ld^T xg = rhs (the sub-blocks in reverse order)."""
        W = self.plan.W
        xg = self._xg[:W]
        xg.zero_()
        for b in reversed(range(W // _SUB)):
            s = b * _SUB
            r = torch.addmv(rhs[s:s + _SUB], Ld[:, s:s + _SUB].T, xg,
                            alpha=-1)
            torch.mv(iL[b].T, r, out=xg[s:s + _SUB])
        return xg

    # ------------------------------------------------------------- solves
    def _solve_lower_impl(self, b):
        n = self.plan.n
        x, bc = self._x, self._bc
        x.zero_()
        bc[:n].copy_(b)
        bc[n:].zero_()
        for t in range(self.plan.nsteps):
            Ld, iL = self._dense_block(t)
            xg = self._solve_window(Ld, iL,
                                    bc.index_select(0, self._cols[t]))
            x.index_copy_(0, self._cols[t], xg)
            # xg is the static (W + 1) vector's head; its slot W stays 0
            contrib = (self._lxp.index_select(0, self._opos[t])
                       * self._xg.index_select(0, self._ocol[t]))
            bc.index_add_(0, self._orow[t], contrib, alpha=-1)
            x[n:].zero_()
            bc[n:].zero_()
        return x[:n]

    def _solve_upper_impl(self, b):
        n, W = self.plan.n, self.plan.W
        x, bp = self._x, self._bc
        bp[:n].copy_(b)
        bp[n:].zero_()
        x.zero_()
        for t in reversed(range(self.plan.nsteps)):
            Ld, iL = self._dense_block(t)
            # off-block contributions: sum_i L[i, j] x[i], i outside the
            # window
            contrib = (self._lxp.index_select(0, self._opos[t])
                       * x.index_select(0, self._orow[t]))
            s = torch.zeros(W + 1, dtype=self.dtype, device=self.device)
            s.index_add_(0, self._ocol[t], contrib)
            rhs = bp.index_select(0, self._cols[t]) - s[:W]
            x.index_copy_(0, self._cols[t], self._solve_window_t(Ld, iL, rhs))
            x[n:].zero_()
        return x[:n]

    def _solve(self, name, lx, b) -> torch.Tensor:
        """Run the solve program ``name`` on ``lx`` and ``b`` (copied into
        the static tensors unless they hold them) and return a clone of
        its x."""
        self._load("lx", (self._lxp[:self.plan.nnz],), (lx,))
        b = torch.as_tensor(b)
        if b.shape != (self.plan.n,):
            raise ValueError(f"expected a vector of {self.plan.n}, got "
                             f"{tuple(b.shape)}")
        self._b_in.copy_(b)
        impl = {"solve_lower": self._solve_lower_impl,
                "solve_upper": self._solve_upper_impl}[name]
        self._program(name, lambda: self._x_out.copy_(
            impl(self._b_in))).run()
        return self._x_out.clone()

    def solve_lower(self, lx, b) -> torch.Tensor:
        """x = L^{-1} b over the coarse schedule."""
        return self._solve("solve_lower", lx, b)

    def solve_upper(self, lx, b) -> torch.Tensor:
        """x = L^{-T} b over the coarse schedule."""
        return self._solve("solve_upper", lx, b)
