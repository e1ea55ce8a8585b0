"""Ownership-partitioned distributed supernodal executor, one rank of a
``Group`` (SURVEY §7E).

Counterpart of ``parsy_bench_tpu/parallel/dist.py`` on the same
``DistPlan`` (``symbolic/dplan.py``).  Where the JAX executor runs one
``shard_map`` program over a 1-D mesh, each rank process
(``parallel/comm.py``) runs the step loop op by op on its own device and
each ``psum`` over the mesh axis is ``group.psum``:

* each rank holds ONLY its own panels: per-class pools (nrows, c), the
  rank's row of every G-leading table of the plan;
* the update chunks whose SOURCE panels the rank owns run on it; a chunk
  whose target has the same owner lands in the local level window, a
  cross-owner chunk in a per-class ragged boundary send buffer;
* one ``psum`` per (class, level step) reduces the send buffers, and each
  rank applies only its own slice of it to its boundary window rows;
* the finalize is local: the single-device executor's unfused finalize
  body (``ops/supernodal.fin_inverses``: ``masked_spd`` + ``chol_inverse``,
  kernel K1 on the card; ``fin_land``: TRSM-as-GEMM and the delta) on
  the rank's own panels, one chol group per class;
* the solves move boundary slots only (one ragged ``psum`` per level
  step) and assemble x with one final ``psum`` (entries are
  owner-disjoint).

Differences from the JAX executor, none of which changes a result: the
per-step scalars (window starts, bucket offsets, lane counts, ragged
offsets) stay numpy on the host, so slices are Python slices; the pools
of ``factorize`` are this rank's (the JAX program returns the (G, nrows,
c) arrays sharded over the mesh); ``factor_values`` returns the full
values on every rank, as a tensor on its device, by one ``psum`` of each
rank's owner-disjoint entries (the JAX version gathers the pools on the
host).  The step loop runs op by op: a CUDA graph cannot hold a gloo
collective, and NCCL, whose collectives a graph can hold, needs one card
per rank.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from parsy_bench_tpu_torch.ops import supernodal
from parsy_bench_tpu_torch.ops.device import (refuse_tf32, require,
                                              torch_dtype)
from parsy_bench_tpu_torch.parallel.comm import group_device
from parsy_bench_tpu_torch.symbolic.dplan import DistPlan


@dataclasses.dataclass
class _DUpd:
    a8: torch.Tensor          # (T, P) first packed row of the A chunk
    b8: torch.Tensor          # (T, P) first packed row of the B operand
    colq: torch.Tensor        # (T, P, Q) target column; pad -> c
    dst: torch.Tensor         # (T, P, Mc) extended-delta row


@dataclasses.dataclass
class _DFin:
    cnt: np.ndarray           # (T,) host: true lanes
    boff: np.ndarray          # (T,) host: window-local slice offset
    w: torch.Tensor           # (T, P) logical widths
    cols0: torch.Tensor       # (T, P) first global column; pad -> n
    rows: torch.Tensor        # (T, P, H) global rows; pad -> n
    rdst: torch.Tensor        # (T, P, H) lower-solve extended-delta row


@dataclasses.dataclass
class _DSeg:
    rlo: np.ndarray           # (T, ncls) host: window starts
    upd: list                 # _DUpd per update bucket
    fin: list                 # _DFin per finalize bucket
    brows: list               # per class: (T, bc) own boundary window rows
    boff: list                # per class: (T,) host offset into the buffer
    sl_boff: np.ndarray       # (T,) host: own lower-solve slot offset
    sl_rows: torch.Tensor     # (T, sl_bc) global rows; pad -> n
    su_slot: torch.Tensor     # (T, su_ks) slots this rank fills; pad -> btot
    su_srow: torch.Tensor     # (T, su_ks) their global rows; pad -> n
    su_boff: np.ndarray       # (T,) host: own upper-solve slot offset
    su_rows: torch.Tensor     # (T, su_bc) global rows; pad -> n


class DistExecutor:
    """Numeric phase of one ``DistPlan`` in one rank of ``group``, on the
    card unless the caller passes ``device="cpu"`` (the device must be the
    group's)."""

    def __init__(self, plan: DistPlan, group, dtype="float32",
                 device="cuda"):
        if group.size != plan.G:
            raise ValueError(f"plan built for {plan.G} devices, group has "
                             f"{group.size}")
        self.device = group_device(group, device)
        refuse_tf32(self.device)
        self.plan = plan
        self.group = group
        self.G, self.rank = int(plan.G), int(group.rank)
        self.dtype = torch_dtype(dtype)
        self.classes = tuple(int(c) for c in plan.classes)
        self.ncls = len(self.classes)
        self._nrows = [int(r) for r in plan.nrows]
        for ci, r in enumerate(self._nrows):
            require(r % 8 == 0, f"class {ci} pool rows {r} not packed")
        self._iota = {}
        self._lmap = None
        g, n = self.rank, int(plan.n)
        # A scatter maps: padded entries add A[0] onto each pool's trash
        # row (the last), which no table reads
        self._nnz_a = 0
        maps = []
        for ci, (m, r, c) in enumerate(zip(plan.a_map, self._nrows,
                                           self.classes)):
            m = np.asarray(m, dtype=np.int64)
            trash = (r - 1) * c
            self._nnz_a += int((m[:, 0] != trash).sum())
            maps.append((m[g], r * c, ci))
        for mg, size, ci in maps:
            require(mg.shape[1] == 0
                    or (0 <= mg.min() and mg[0].max() < size
                        and mg[1].max() < max(self._nnz_a, 1)),
                    f"a_map class {ci} outside its pool or the A values")
        self._a_map = [(self._up(mg[0], torch.int64),
                        self._up(mg[1], torch.int64)) for mg, _, _ in maps]
        oc = plan.owner_col if plan.owner_col is not None else np.zeros(
            n + 1, dtype=np.int32)
        self._owner_col = self._up(oc)
        self._segs = [self._ingest(seg) for seg in plan.segments]

    # ----------------------------------------------------------- tables
    def _up(self, arr, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(arr)).to(
            device=self.device, dtype=dtype)

    def _ar(self, k):
        """Cached device arange(k) (int64)."""
        if k not in self._iota:
            self._iota[k] = torch.arange(k, device=self.device)
        return self._iota[k]

    def _ingest(self, seg) -> _DSeg:
        """This rank's row of the segment's tables, bounds-checked (JAX
        clamps out-of-range slices and gathers silently)."""
        g, n, T = self.rank, int(self.plan.n), seg.nsteps
        rlo = np.asarray(seg.rlo[g], dtype=np.int64).reshape(T, self.ncls)
        for ci, W in enumerate(seg.wslice):
            require(np.all(rlo[:, ci] >= 0)
                    and np.all(rlo[:, ci] + W <= self._nrows[ci]),
                    f"class {ci} row window past the pool end")
        upd = []
        for b in seg.upd:
            a8 = np.asarray(b.arow[g], dtype=np.int64) // 8
            b8 = np.asarray(b.brow[g], dtype=np.int64) // 8
            rows8 = self._nrows[b.kcls] // 8
            require(a8.min(initial=0) >= 0
                    and a8.max(initial=0) + b.Mc // 8 <= rows8
                    and b8.min(initial=0) >= 0
                    and b8.max(initial=0) + b.Q // 8 <= rows8,
                    "update operand gather past the pool end")
            require(np.all((b.colq[g] >= 0) & (b.colq[g] <= b.c)),
                    "update column index outside the target width")
            ext = seg.wslice[b.ccls] + seg.btot[b.ccls]
            require(np.all((b.dst[g] >= 0) & (b.dst[g] <= ext)),
                    "update delta row outside the extended delta")
            upd.append(_DUpd(a8=self._up(a8), b8=self._up(b8),
                             colq=self._up(b.colq[g]),
                             dst=self._up(b.dst[g], torch.int64)))
        require(len(seg.sl_rdst) == len(seg.fin),
                "one lower-solve target table per finalize bucket")
        fin = []
        for b, rdst in zip(seg.fin, seg.sl_rdst):
            boff = np.asarray(b.boff[g], dtype=np.int64)
            cnt = np.asarray(b.cnt[g], dtype=np.int64)
            require(np.all(boff >= 0)
                    and np.all(boff + b.P * b.H <= seg.wslice[b.ccls])
                    and np.all((cnt >= 0) & (cnt <= b.P)) and b.H >= b.c,
                    "finalize bucket slice past the window end, or its "
                    "lane count outside [0, P]")
            require(np.all((b.w[g] >= 0) & (b.w[g] <= b.c))
                    and np.all((b.cols0[g] >= 0) & (b.cols0[g] <= n))
                    and np.all((b.rows[g] >= 0) & (b.rows[g] <= n))
                    and np.all((rdst[g] >= 0)
                               & (rdst[g] < n + 1 + seg.sl_btot)),
                    "finalize width, column, row or solve target out of "
                    "range")
            fin.append(_DFin(cnt=cnt, boff=boff, w=self._up(b.w[g]),
                             cols0=self._up(b.cols0[g], torch.int64),
                             rows=self._up(b.rows[g], torch.int64),
                             rdst=self._up(rdst[g], torch.int64)))
        for ci, W in enumerate(seg.wslice):
            require(np.all((seg.brows[ci][g] >= 0)
                           & (seg.brows[ci][g] <= W))
                    and np.all((seg.boff[ci][g] >= 0)
                               & (seg.boff[ci][g] <= seg.btot[ci])),
                    f"class {ci} boundary row or offset out of range")
        require(np.all((seg.sl_boff[g] >= 0)
                       & (seg.sl_boff[g] <= seg.sl_btot))
                and np.all((seg.su_boff[g] >= 0)
                           & (seg.su_boff[g] <= seg.su_btot))
                and np.all((seg.su_slot[g] >= 0)
                           & (seg.su_slot[g] <= seg.su_btot))
                and all(np.all((x[g] >= 0) & (x[g] <= n))
                        for x in (seg.sl_rows, seg.su_srow, seg.su_rows)),
                "solve slot, offset or row out of range")
        return _DSeg(
            rlo=rlo, upd=upd, fin=fin,
            brows=[self._up(x[g], torch.int64) for x in seg.brows],
            boff=[np.asarray(x[g], dtype=np.int64) for x in seg.boff],
            sl_boff=np.asarray(seg.sl_boff[g], dtype=np.int64),
            sl_rows=self._up(seg.sl_rows[g], torch.int64),
            su_slot=self._up(seg.su_slot[g], torch.int64),
            su_srow=self._up(seg.su_srow[g], torch.int64),
            su_boff=np.asarray(seg.su_boff[g], dtype=np.int64),
            su_rows=self._up(seg.su_rows[g], torch.int64))

    @property
    def chol_calls_per_factorize(self) -> int:
        """``chol_inverse`` calls one ``factorize`` makes: one per class
        that finalizes panels, per level step (on every rank)."""
        return sum(seg.nsteps * len({b.ccls for b in seg.fin})
                   for seg in self.plan.segments)

    # ------------------------------------------------------------ pools
    def _zeros(self, *shape):
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def _init_pools(self, a):
        pools = []
        for (pos, src), r, c in zip(self._a_map, self._nrows, self.classes):
            flat = self._zeros(r * c)
            flat.index_add_(0, pos, a[src])
            pools.append(flat.view(r, c))
        return pools

    def _a(self, a_data):
        a = torch.as_tensor(a_data)
        if a.shape != (self._nnz_a,):
            raise ValueError(f"expected {self._nnz_a} A values, got "
                             f"{tuple(a.shape)}")
        return a.to(device=self.device, dtype=self.dtype)

    # ------------------------------------------------------------- step
    def _step(self, pools, seg, st, t):
        wins = [pools[ci][int(st.rlo[t, ci]):int(st.rlo[t, ci]) + W]
                for ci, W in enumerate(seg.wslice)]
        # updates into extended deltas [window | ragged send | dummy]; all
        # operands are gathered before any window is written
        deltas = [self._zeros(W + bt + 1, c) for W, bt, c in
                  zip(seg.wslice, seg.btot, self.classes)]
        for b, ut in zip(seg.upd, st.upd):
            C = supernodal.update_block(
                pools[b.kcls].view(-1, 8 * b.K), ut.a8[t], ut.b8[t],
                ut.colq[t], b, self._ar, self.dtype)
            deltas[b.ccls].index_add_(0, ut.dst[t].reshape(-1),
                                      C.reshape(-1, b.c))
        # boundary-only reduction: the ragged send buffer is psum'd once;
        # each rank applies only its own slice [boff, boff + bc) to its
        # boundary window rows
        for ci, c in enumerate(self.classes):
            W, bc, bt = seg.wslice[ci], seg.bc[ci], seg.btot[ci]
            recv = self.group.psum(deltas[ci][W:W + bt])
            off = int(st.boff[ci][t])
            own = torch.cat([recv, self._zeros(bc, c)])[off:off + bc]
            wins[ci].sub_(deltas[ci][:W])
            land = self._zeros(W + 1, c)
            land.index_add_(0, st.brows[ci][t], own)
            wins[ci].sub_(land[:W])
        # the local finalize on the rank's own panels: one chol group of
        # all of a class's buckets, so one ``chol_inverse`` per class
        for ci in range(self.ncls):
            ks = [k for k, b in enumerate(seg.fin) if b.ccls == ci]
            if not ks:
                continue
            win = wins[ci]
            delta = torch.zeros_like(win)
            lanes = [supernodal.fin_lanes(win, seg.fin[k], st.fin[k], t)
                     for k in ks]
            supernodal.fin_land(win, delta, lanes, supernodal.fin_inverses(
                [lanes], self.dtype))

    # --------------------------------------------------------- programs
    def _run_segments(self, pools, lo, hi):
        for seg, st in zip(self.plan.segments[lo:hi], self._segs[lo:hi]):
            for t in range(seg.nsteps):
                self._step(pools, seg, st, t)

    def factorize(self, a_data):
        """A values (replicated; numpy or a tensor) -> this rank's pools, a
        tuple of (nrows, c) tensors on its device."""
        pools = self._init_pools(self._a(a_data))
        self._run_segments(pools, 0, len(self._segs))
        return tuple(pools)

    def factorize_segmented(self, a_data, group: int = 8):
        """``factorize`` in runs of ``group`` segments, the counterpart of
        the JAX grouped programs (there, bounded compile size): here the
        same operations in the same order, so it equals ``factorize``."""
        group = int(group)
        if group < 1:
            raise ValueError(f"group {group} < 1")
        pools = self._init_pools(self._a(a_data))
        nseg = len(self._segs)
        for lo in range(0, nseg, group):
            self._run_segments(pools, lo, min(lo + group, nseg))
        return tuple(pools)

    # ------------------------------------------------------------ solves
    def _vec(self, b):
        b = torch.as_tensor(b)
        if b.shape != (self.plan.n,):
            raise ValueError(f"expected a vector of {self.plan.n}, got "
                             f"{tuple(b.shape)}")
        return b.to(device=self.device, dtype=self.dtype)

    def _panel(self, pools, b, ft, st, t):
        start = int(st.rlo[t, b.ccls]) + int(ft.boff[t])
        return pools[b.ccls][start:start + b.P * b.H].view(b.P, b.H, b.c)

    def _solve_lower_body(self, pools, b_vec):
        """Forward substitution with boundary-only communication: each
        rank solves its own panels and applies right-hand-side updates to
        its own columns; cross-owner contributions ride one ragged psum
        of boundary slots per level step (dplan ``sl_*``); x stays
        owner-distributed and is assembled by one final psum."""
        n = int(self.plan.n)
        x = self._zeros(n + 1)
        bc = torch.cat([b_vec, self._zeros(1)])
        for seg, st in zip(self.plan.segments, self._segs):
            SL = seg.sl_btot
            for t in range(seg.nsteps):
                dx = self._zeros(n + 1)
                # extended RHS delta: [n+1 local | SL boundary slots]
                D = self._zeros(n + 1 + SL)
                for b, ft in zip(seg.fin, st.fin):
                    blk = self._panel(pools, b, ft, st, t)
                    w = ft.w[t]
                    Linv = supernodal.inv_blk(blk, w, self._ar(b.c))
                    lanev = (self._ar(b.P) < int(ft.cnt[t]))[:, None]
                    arc = self._ar(b.c)
                    cidx = torch.clamp(ft.cols0[t][:, None] + arc, max=n)
                    colv = (arc[None, :] < w[:, None]) & lanev
                    bvec = bc[cidx] * colv
                    xs_ = torch.bmm(Linv, bvec[:, :, None])[:, :, 0] * colv
                    dx.index_add_(0, torch.where(colv, cidx, n).reshape(-1),
                                  xs_.masked_fill(~colv, 0).reshape(-1))
                    y = torch.bmm(blk, xs_[:, :, None])[:, :, 0]
                    below = (self._ar(b.H)[None, :] >= w[:, None]) & lanev
                    # rdst: n for diagonal and padded rows, the global row
                    # for local rows below, (n+1)+slot for cross rows
                    D.index_add_(0, torch.where(below, ft.rdst[t],
                                                n).reshape(-1),
                                 (-(y * below)).reshape(-1))
                recv = self.group.psum(D[n + 1:n + 1 + SL])
                off = int(st.sl_boff[t])
                own = torch.cat([recv, self._zeros(seg.sl_bc)])[
                    off:off + seg.sl_bc]
                # own columns: solved entries are owner-exclusive
                x = x + dx
                x[n:].zero_()
                bc = bc + D[:n + 1]
                bc.index_add_(0, st.sl_rows[t], own)
                bc[n:].zero_()
        # owner-disjoint entries: one assembly psum for the whole solve
        return self.group.psum(x[:n])

    def _solve_upper_body(self, pools, b_vec):
        """Backward substitution with boundary-only x delivery: each owner
        solves its columns; the freshly solved entries other ranks read
        ride one ragged psum of boundary slots per step (dplan ``su_*``)
        into the readers' local x; the assembly masks each rank to its own
        columns (delivered copies must not count twice)."""
        n = int(self.plan.n)
        x = self._zeros(n + 1)
        bp = torch.cat([b_vec, self._zeros(1)])
        for seg, st in zip(reversed(self.plan.segments),
                           reversed(self._segs)):
            SU = seg.su_btot
            for t in reversed(range(seg.nsteps)):
                dx = self._zeros(n + 1)
                for b, ft in zip(seg.fin, st.fin):
                    blk = self._panel(pools, b, ft, st, t)
                    w = ft.w[t]
                    Linv = supernodal.inv_blk(blk, w, self._ar(b.c))
                    lanev = (self._ar(b.P) < int(ft.cnt[t]))[:, None]
                    below = self._ar(b.H)[None, :] >= w[:, None]
                    xr = x[ft.rows[t]] * below
                    tt = torch.bmm(blk.transpose(1, 2),
                                   xr[:, :, None])[:, :, 0]
                    arc = self._ar(b.c)
                    cidx = torch.clamp(ft.cols0[t][:, None] + arc, max=n)
                    colv = (arc[None, :] < w[:, None]) & lanev
                    rhs = (bp[cidx] - tt) * colv
                    xs_ = torch.bmm(Linv.transpose(1, 2),
                                    rhs[:, :, None])[:, :, 0] * colv
                    dx.index_add_(0, torch.where(colv, cidx, n).reshape(-1),
                                  xs_.masked_fill(~colv, 0).reshape(-1))
                x = x + dx
                x[n:].zero_()
                # deliver the just-solved boundary entries: the column
                # owner fills its slots (padding onto slot SU), readers
                # copy their slice (padding onto the dummy n)
                send = self._zeros(SU + 1)
                send[st.su_slot[t]] = x[st.su_srow[t]]
                recv = self.group.psum(send[:SU])
                off = int(st.su_boff[t])
                own = torch.cat([recv, self._zeros(seg.su_bc)])[
                    off:off + seg.su_bc]
                x[st.su_rows[t]] = own
                x[n:].zero_()
        mine = self._owner_col[:n] == self.rank
        return self.group.psum(torch.where(mine, x[:n], 0.0))

    def solve_lower(self, pools, b):
        """x = L^{-1} b (replicated in and out)."""
        return self._solve_lower_body(pools, self._vec(b))

    def solve_upper(self, pools, b):
        """x = L^{-T} b."""
        return self._solve_upper_body(pools, self._vec(b))

    def solve_spd(self, pools, b):
        """x = (L L^T)^{-1} b."""
        return self._solve_upper_body(
            pools, self._solve_lower_body(pools, self._vec(b)))

    # ------------------------------------------------------------ export
    def _owned_entries(self, lpat):
        """Per class, (pool position, value index) of the entries of the
        simplicial pattern ``lpat`` whose panel this rank owns (host
        tables, kept for the last ``lpat``)."""
        if self._lmap is not None and self._lmap[0] is lpat:
            return self._lmap[1]
        meta = self.plan.layout_meta
        part, rptr, rows = meta["part"], meta["rptr"], meta["rows"]
        rowoff, owner, cls = meta["rowoff"], meta["owner"], meta["cls"]
        n = int(self.plan.n)
        lptr = lpat.indptr.astype(np.int64)
        li = lpat.indices.astype(np.int64)
        lcol = np.repeat(np.arange(n, dtype=np.int64), np.diff(lptr))
        s = part.col2sup.astype(np.int64)[lcol]
        sup_of_row = np.repeat(np.arange(part.nsuper, dtype=np.int64),
                               np.diff(rptr))
        row_keys = sup_of_row * np.int64(n + 1) + rows.astype(np.int64)
        r = np.searchsorted(row_keys, s * np.int64(n + 1) + li)
        require(np.all(r < len(rows)) and np.all(rows[np.minimum(
            r, len(rows) - 1)] == li), "L entry outside the supernodal rows")
        rloc = rowoff[s] + (r - rptr[s])
        ccol = lcol - part.sptr[s]
        maps = []
        for ci, c in enumerate(self.classes):
            sel = np.nonzero((cls[s] == ci) & (owner[s] == self.rank))[0]
            maps.append((self._up(rloc[sel] * c + ccol[sel], torch.int64),
                         self._up(sel, torch.int64)))
        self._lmap = (lpat, (maps, len(li)))
        return self._lmap[1]

    def factor_values(self, pools, lpat) -> torch.Tensor:
        """Values of the simplicial pattern ``lpat`` (nnz,), on every rank:
        each rank places the entries of its own panels and one ``psum``
        assembles them (they are owner-disjoint, so the sum is exact).
        Verification path."""
        maps, nnz = self._owned_entries(lpat)
        out = self._zeros(nnz)
        for (pos, sel), p in zip(maps, pools):
            out[sel] = p.reshape(-1)[pos]
        return self.group.psum(out)
