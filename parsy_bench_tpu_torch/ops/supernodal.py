"""Supernodal numeric executor in PyTorch: factorize and blocked solves.

Counterpart of ``parsy_bench_tpu/ops/supernodal.py`` on the same
``SupernodalPlan`` (``parsy_bench_tpu_torch/symbolic/splan.py``):

* ``factorize`` — parallel left-looking supernodal Cholesky (reference
  cholesky_left_par_05, parallel_PB_Cholesky_05.h:27).  Per wavefront
  level step: every update pair runs as lanes of two batched GEMMs over
  row-gathered operands (the dsyrk/dgemm pair, :160-173), landed on the
  level's row window either through the plan's static gather/ladder
  tables (``update_delta="gather"``) or a row ``index_add_``
  (``"scatter"``); then panel finalization (dpotrf/dtrsm, :204-218) runs
  one batched Cholesky + inverse per width class (``chol_inverse``: the
  CUDA kernel on the card, ``ops/dense.py`` on the CPU) and one GEMM
  against the triangular inverse.  With ``fused_finalize=True`` the
  classes of width <= 64 instead run the whole finalize of a bucket as one
  ``finalize_fused`` call (kernel K2 on the card).  The JAX ``lax.scan``
  over level steps is a Python loop here.
* ``solve_lower`` — the pair-granular forward solve: ``solve_prep`` builds
  slot-ordered Linv pools once per factorization, and each level step
  lands one aligned row per update pair and runs one batched product per
  class (reference: H2LeveledBlockedLsolve, Triangular_BCSC.h:171).  A
  plan with a dense top (``dense_top_cols``) ends the level steps at
  ``solve_nseg`` and solves the top as one product with its explicit
  inverse (``top_inverse``; the peeled last level,
  H2LeveledBlockedLsolve_Peeled, Triangular_BCSC.h:238); with the
  aligned-operand pool (``_gpool_enabled``, within ``solve_gpool_mb``)
  each update pair reads its column-aligned block from a slab built by
  ``solve_prep`` in place of the gather and the one-hot product;
* ``solve_upper`` / ``solve_spd`` — leveled blocked solves over the same
  wavefront schedule (``solve_spd`` runs the leveled forward solve, as the
  JAX executor's does); each bucket lands only its real entries, by index
  lists fixed at construction (``solve_scatter_lists``), where the JAX
  executor sends every padded lane to a pad slot;
* ``factorize_segmented``, ``factorize_loop``, ``solve_loop`` and
  ``profile_segments`` — the JAX executor's benchmark entry points;
* ``init_pools`` and ``prepare_solve_pools`` — a given factor's values
  placed in the pools and its diagonal blocks' inverses stored, for the
  blocked ``TriangularSolver`` on a trisolve plan
  (``symbolic/strisolve.py``: finalize buckets, no update buckets);
* ``_step(..., group, groups)`` and the leveled solves with ``group``,
  the counterparts of the JAX executor's ``axis_name`` branches, which
  ``parallel/sharded.py`` runs on a plan with ``num_partitions`` = G in
  each of G ranks (``group``, ``parallel/comm.py``): each rank takes its
  own shard of every update bucket's lanes and its owner-strided
  finalize and solve lanes (lane % G == rank), and one ``psum`` per class
  delta, finalize delta or solve step merges them.  The unfused finalize
  is one body for every caller (``fin_lanes``, ``fin_inverses``,
  ``fin_land``): the single-device step, a rank's step (at G = 1 the
  single-device views), ``parallel/dist.py``'s step and
  ``scripts/fin_ablate.py``'s variants.

Every entry point that the JAX executor compiles runs here as captured
programs (``ops/graphs.py``): closures over static tensors (the A values
in, the pools, the Linv pools, b and x), captured as CUDA graphs at their
first call on the card and replayed after; on the CPU the same closures
run.  Inputs are copied into the static tensors outside the programs, and
results leave as clones, so that no later call overwrites what a caller
holds (the JAX package returns new arrays from every call).  Each graph
belongs to one plan: the per-step host scalars are constants of its
capture.  ``_factorize_eager`` runs the step loop op by op on fresh pools;
it is the reference the programs are held against on the card.

Pools keep the JAX package's packed layout, per width class c a
(R/8, 8c) tensor with the linear element order of (R, c), so they compare
element-wise with the JAX executor's.  Pool invariant: padding is zero.

Differences from the JAX executor, none of which changes a result:

* index tables are per-table device tensors; the per-step scalars that set
  slice offsets (window start ``rlo``, bucket offset ``boff``, true lane
  count ``cnt``) stay numpy on the host, so no step waits on the device;
* every window, bucket slice and gather the plan implies (slot windows
  and Linv-pool slices of the fast solve included) is bounds-checked on
  the host when the executor is built.  JAX clamps out-of-range slices
  and gathers silently; here an out-of-range plan raises;
* row windows are views into the pools and are updated in place.  Each
  phase of a step (updates, then finalize) finishes all of its reads
  before its one write per class, which is what the JAX copies give; the
  fused finalize and the fast solve's slot windows likewise gather every
  operand of a step before they write.

The single-device factorize step runs each of its pieces inside a span
(``ops/trace.span``, ``SCOPES``), and the leveled solves inside
``SOLVE_SCOPES``: under a profiler the per-layer device time of
``scripts/floor_r5.py``'s ``layers_ms``; in a captured program the scope
of each graph node (``graphs.Program.scopes``), since a replay opens no
span.  A span launches nothing; outside a profile and a capture it costs
a flag check.  The entry points open ``executor.load`` around the inputs'
copies into the static tensors and ``executor.clone`` around the clones
they return.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from parsy_bench_tpu_torch.ops import dense, graphs, kernels, trace
from parsy_bench_tpu_torch.ops.device import (refuse_tf32, require,
                                              resolve_device, torch_dtype)
from parsy_bench_tpu_torch.symbolic.splan import SupernodalPlan, SupSegment

_scope = trace.span
#: the factorize step's scopes: the A values' scatter into the pools
#: (``_init_pools``); the update operands' gathers, their product and the
#: one-hot alignment (``update_block``); the call buffer, the ladder sums
#: and the window take and subtract (``_apply_updates_gather``; in the
#: scatter branch, the delta buffers, the products' landing in them and
#: their subtraction); the masked SPD build and K1 (``fin_inverses``), the
#: finalize tail and the delta (``fin_land``)
SCOPES = ("init", "upd.operands", "upd.product", "upd.align", "upd.cat",
          "upd.ladder", "upd.take_sub", "fin.spd", "fin.k1", "fin.diff",
          "fin.delta")
#: the solves' scopes: the forward (``_solve_lower_impl`` and the fast
#: ``_solve_lower_fast_impl``) and the backward substitution
#: (``_solve_upper_impl``)
SOLVE_SCOPES = ("slv.lower", "slv.upper")

def chol_inverse(D):
    """Batched masked-SPD Cholesky + inverse: the CUDA kernel for a CUDA
    tensor (``ops/kernels.cholesky_inverse_cuda``), the plain PyTorch
    version for a CPU tensor (``ops/dense.cholesky_inverse``)."""
    if D.device.type == "cuda":
        return kernels.cholesky_inverse_cuda(D)
    if D.device.type == "cpu":
        return dense.cholesky_inverse(D)
    raise ValueError(f"unsupported device {D.device}")


def finalize_fused(blk, w, cnt):
    """The whole per-bucket finalize (masked SPD, Cholesky + inverse, Ltop,
    Y, lane-masked diff): the CUDA kernel for a CUDA tensor
    (``ops/kernels.finalize_fused_cuda``), the plain PyTorch version for a
    CPU tensor (``ops/dense.finalize_fused``)."""
    if blk.device.type == "cuda":
        return kernels.finalize_fused_cuda(blk, w, cnt)
    if blk.device.type == "cpu":
        return dense.finalize_fused(blk, w, cnt)
    raise ValueError(f"unsupported device {blk.device}")


#: widest class the fused finalize takes, as in the JAX executor
FUSED_MAX_WIDTH = 64


def chol_groups(plan, seg, ks, c, G):
    """The finalize buckets ``ks`` (of width c) of ``seg`` in consecutive
    runs, one ``chol_inverse`` batch each, whose lanes per rank (P / G)
    total at most ``plan.fin_chol_elems`` / c^2, so that every (sumP, c,
    c) temp stays bounded (a run holds at least one bucket)."""
    cap = max(1, int(getattr(plan, "fin_chol_elems", 32 * 2**20)) // (c * c))
    groups, cur, cur_p = [], [], 0
    for k in ks:
        p = seg.fin[k].P // G
        if cur and cur_p + p > cap:
            groups.append(cur)
            cur, cur_p = [], 0
        cur.append(k)
        cur_p += p
    if cur:
        groups.append(cur)
    return groups


def inv_blk(blk, w, ar):
    """The diag block's triangular inverse from a factored panel block
    blk (P, H, c) of widths w (P,): strict lower = transpose of the
    Linv^T stored in the strict upper triangle by the finalize, diagonal
    = 1/l_ii (zero on padded columns).  ``ar`` is ``arange(c)`` on the
    block's device."""
    c = ar.shape[0]
    i = ar[None, :, None]
    j = ar[None, None, :]
    wv = w[:, None, None]
    top = blk[:, :c, :]
    strict = top.transpose(1, 2).masked_fill(
        ~((i > j) & (i < wv) & (j < wv)), 0)
    dvec = torch.diagonal(top, dim1=1, dim2=2)
    valid = ar[None, :] < w[:, None]
    dinv = torch.where(valid, 1.0 / torch.where(valid, dvec, 1.0), 0.0)
    return strict + torch.diag_embed(dinv)


def update_block(pool8, a8, b8, colq, b, ar, dtype):
    """One update bucket's lanes: C = (A @ B_raw^T) @ S^T, (lanes, Mc, c),
    with A the Mc-row chunks at packed rows ``a8`` and B_raw the Q-row
    operands at ``b8`` of the packed pool ``pool8`` (R/8, 8K), and S the
    one-hot column-alignment selector from ``colq`` (lanes, Q).  ``ar(k)``
    is ``arange(k)`` on the pool's device."""
    with _scope("upd.operands"):
        A = pool8[a8[:, None] + ar(b.Mc // 8)].reshape(-1, b.Mc, b.K)
        Braw = pool8[b8[:, None] + ar(b.Q // 8)].reshape(-1, b.Q, b.K)
    with _scope("upd.product"):
        Chat = torch.bmm(A, Braw.transpose(1, 2))
    with _scope("upd.align"):
        S = (ar(b.c)[None, :, None] == colq[:, None, :]).to(dtype)
        return torch.bmm(Chat, S.transpose(1, 2))


@dataclasses.dataclass
class FinLanes:
    """Lanes g, g + G, ... of one finalize bucket at one level step: rank
    g of G's (every lane at G = 1)."""
    blk: torch.Tensor         # (P / G, H, c) view into the window
    w: torch.Tensor           # (P / G,) logical widths
    cnt: int                  # true lanes among them (a prefix)
    rows: slice               # the bucket's window rows
    g: int = 0
    G: int = 1


def fin_lanes(win, b, ft, t, g=0, G=1) -> FinLanes:
    """Bucket ``b``'s ``FinLanes`` of rank g of G in the class window
    ``win`` at step t, from its tables ``ft`` (``boff``, ``cnt``, ``w``).
    At G = 1 the views take no lane axis, so that the single-device step
    records no select or alias operation in a profile."""
    off = int(ft.boff[t])
    rows = slice(off, off + b.P * b.H)
    cnt = max(0, -(-(int(ft.cnt[t]) - g) // G))
    if G == 1:
        return FinLanes(win[rows].view(b.P, b.H, b.c), ft.w[t], cnt, rows)
    return FinLanes(win[rows].view(-1, G, b.H, b.c)[:, g],
                    ft.w[t].view(-1, G)[:, g], cnt, rows, g, G)


def fin_inverses(groups, dtype, chol=None) -> list:
    """The unfused finalize's first half for one width class: per chol
    group (a list of ``FinLanes``) the masked SPD of the tops and one
    ``chol`` call (``chol_inverse``, looked up here, unless given); (L,
    Linv) per bucket in the groups' order."""
    facs = []
    for grp in groups:
        c = grp[0].blk.shape[2]
        with _scope("fin.spd"):
            D = dense.masked_spd(torch.cat([x.blk[:, :c, :] for x in grp]),
                                 torch.cat([x.w for x in grp]), c, dtype)
        with _scope("fin.k1"):
            L, Linv = (chol or chol_inverse)(D)
        lo = 0
        for x in grp:
            hi = lo + x.blk.shape[0]
            facs.append((L[lo:hi], Linv[lo:hi]))
            lo = hi
    return facs


def fin_land(win, delta, lanes, facs, group=None, diff=None):
    """The second half: each bucket's ``diff`` (``dense.finalize_diff``
    unless given; it leaves Linv^T in the diag block's strict upper
    triangle, for the solves) landed in the zero ``delta``, one ``psum``
    of it with ``group``, then ``win += delta``."""
    for x, (L, Linv) in zip(lanes, facs):
        with _scope("fin.diff"):
            d = (diff or dense.finalize_diff)(x.blk, x.w, x.cnt, L, Linv)
        with _scope("fin.delta"):
            if x.G == 1:
                delta[x.rows] += d.view(-1, d.shape[2])
            else:
                delta[x.rows].view(-1, x.G, *d.shape[1:])[:, x.g] += d
    with _scope("fin.delta"):
        if group is not None:
            group.psum(delta)
        win += delta


def _lanes_major(arr):
    """(G, T, P, ...) update table -> (T, G*P, ...): the unsharded
    executor runs the G shard groups of a step as one batch."""
    arr = np.moveaxis(np.asarray(arr), 0, 1)
    return arr.reshape((arr.shape[0], -1) + arr.shape[3:])


@dataclasses.dataclass
class _UpdTables:
    a8: torch.Tensor          # (T, GP) first packed row of the A chunk
    b8: torch.Tensor          # (T, GP) first packed row of the B operand
    colq: torch.Tensor        # (T, GP, Q) target column; pad -> c
    dst: torch.Tensor | None  # (T, GP, Mc) window row; scatter path only


def solve_scatter_lists(w, cols0, rows, c, n, G=1, rank=0):
    """The real entries the leveled solves land for one finalize bucket of
    width ``c`` over its T level steps, from the plan's host arrays ``w``
    (T, P), ``cols0`` (T, P) and ``rows`` (T, P, H), as numpy arrays
    (cpos, ccol, coff, rpos, rrow, roff):

    * ``cpos`` / ``ccol``: the flat positions p*c + j, j < w[t, p], of the
      (P, c) solve block and their columns cols0[t, p] + j;
    * ``rpos`` / ``rrow``: the flat positions p*H + h, h >= w[t, p] and
      rows[t, p, h] < n, of the (P, H) product and their rows;
    * ``coff`` / ``roff``: (T + 1,) offsets of each step's run.

    Each step's run keeps the flat order.  Only the lanes p % G == rank
    (one rank's owner-strided lanes) are listed."""
    w = np.asarray(w, dtype=np.int64)
    cols0 = np.asarray(cols0, dtype=np.int64)
    rows = np.asarray(rows, dtype=np.int64)
    T, P, H = rows.shape
    own = (np.arange(P) % G == rank)[None, :, None]
    colm = (np.arange(c)[None, None, :] < w[:, :, None]) & own
    rowm = ((np.arange(H)[None, None, :] >= w[:, :, None]) & (rows < n)
            & own)
    cpos = np.nonzero(colm.reshape(T, -1))[1]
    rpos = np.nonzero(rowm.reshape(T, -1))[1]
    ccol = (cols0[:, :, None] + np.arange(c))[colm]
    rrow = rows[rowm]
    coff = np.concatenate([[0], np.cumsum(colm.reshape(T, -1).sum(1))])
    roff = np.concatenate([[0], np.cumsum(rowm.reshape(T, -1).sum(1))])
    return cpos, ccol, coff, rpos, rrow, roff


@dataclasses.dataclass
class _Scatter:
    """One finalize bucket's ``solve_scatter_lists`` on the device, each
    list one flat tensor over the bucket's steps; step t's run is the
    view [off[t], off[t + 1]), taken by host integers."""
    cpos: torch.Tensor        # int32
    ccol: torch.Tensor        # int64: index_copy_ takes no other
    coff: np.ndarray          # (T + 1,) host
    rpos: torch.Tensor        # int32
    rrow: torch.Tensor        # int32
    roff: np.ndarray          # (T + 1,) host

    def land_cols(self, x, xs, t):
        """x[ccol] = xs.flat[cpos] over step t's run: a plain scatter
        (same-level panels' columns are disjoint)."""
        lo, hi = int(self.coff[t]), int(self.coff[t + 1])
        if hi > lo:
            x.index_copy_(0, self.ccol[lo:hi],
                          xs.reshape(-1).index_select(0, self.cpos[lo:hi]))

    def sub_rows(self, d, y, t):
        """d[rrow] -= y.flat[rpos] over step t's run, in the run's order
        (same-level panels can share an ancestor row)."""
        lo, hi = int(self.roff[t]), int(self.roff[t + 1])
        if hi > lo:
            d.index_add_(0, self.rrow[lo:hi],
                         y.reshape(-1).index_select(0, self.rpos[lo:hi]),
                         alpha=-1)


@dataclasses.dataclass
class _FinTables:
    cnt: np.ndarray           # (T,) host: true lanes per step
    boff: np.ndarray          # (T,) host: window-local slice offset
    w: torch.Tensor           # (T, P) logical widths
    cols0: torch.Tensor       # (T, P) first global column; pad -> n
    rows: torch.Tensor        # (T, P, H) global rows; pad -> n
    sc: _Scatter              # the leveled solves' real entries


@dataclasses.dataclass
class _SegTables:
    rlo: np.ndarray           # (ncls, T) host: window start row
    upd: list                 # _UpdTables per update bucket
    fin: list                 # _FinTables per finalize bucket
    gsc: list | None          # per class: dict(gidx, pidx) or None
    #: per class: groups of fin-bucket indices sharing one chol_inverse
    #: (empty for a class the fused finalize takes)
    fin_groups: list
    #: per class: fin-bucket indices finalized by ``finalize_fused``, one
    #: call each (empty unless the executor is fused)
    fin_fused: list


@dataclasses.dataclass
class _SolveUpdTables:
    b8: torch.Tensor          # (T, P) first packed row of the B operand
    xrow: torch.Tensor        # (T, P) source panel slot (xb row)
    colq: torch.Tensor        # (T, P, Q) target column; pad -> c
    dst: torch.Tensor         # (T, P) window-local target slot; pad -> Sw


@dataclasses.dataclass
class _SolveTables:
    srlo: np.ndarray          # (ncls, T) host: slot window start
    strue: np.ndarray         # (ncls, T) host: true slots of the level
    soff: list                # per fin bucket: (T,) host slot offset
    supd: list                # _SolveUpdTables per solve-update bucket
    has_cls: list             # per class: the segment finalizes panels


class SupernodalExecutor(graphs.ProgramHost):
    """Numeric phase for one ``SupernodalPlan`` on one device: the card
    unless the caller passes ``device="cpu"`` (plain kernel versions).

    ``fused_finalize`` (off by default, as ``PBT_FUSED_FINALIZE`` is in the
    JAX executor): classes of width <= 64 finalize each bucket with one
    ``finalize_fused`` call (kernel K2 on the card) in place of the shared
    per-class ``chol_inverse`` (K1) and the unfused tail."""

    def __init__(self, plan: SupernodalPlan, dtype, device="cuda",
                 fused_finalize: bool = False):
        self.plan = plan
        self.dtype = torch_dtype(dtype)
        self.device = resolve_device(device)
        refuse_tf32(self.device)
        lay = plan.layout
        self.ncls = lay.ncls
        self.classes = tuple(int(c) for c in lay.classes)
        self.fused_finalize = bool(fused_finalize)
        self._fused_cls = [self.fused_finalize and c <= FUSED_MAX_WIDTH
                           for c in self.classes]
        self._nrows = [int(r) for r in plan.nrows]
        for ci, r in enumerate(self._nrows):
            require(r % 8 == 0, f"class {ci} pool rows {r} not packed")
        self._nnz_a = int(sum(m.shape[1] for m in lay.a_map))
        self._nnz_l = int(lay.nnz_l)
        self._a_map = [self._map(m, ci, self._nnz_a, "a_map")
                       for ci, m in enumerate(lay.a_map)]
        self._l_map = None
        self._iota = {}
        self._segs = [self._ingest(seg) for seg in plan.segments]
        self._rank_scatters = {}
        self._landed = sum(2 * int(ft.sc.coff[-1]) + int(ft.sc.roff[-1])
                           for tabs in self._segs for ft in tabs.fin)
        self._has_fast_solve = (
            plan.bmap is not None
            and all(seg.srlo is not None for seg in plan.segments))
        #: the dense top (``TopSolve``) and the aligned-operand pool, as in
        #: the JAX executor: only with the fast solve's tables
        self._top = None
        self._gpool_enabled = False
        if self._has_fast_solve:
            self._ingest_solve()
        # the static tensors of the programs, allocated once, outside any
        # capture
        dev, dt = self.device, self.dtype
        self._a_in = torch.zeros(self._nnz_a, dtype=dt, device=dev)
        self._pools = tuple(
            torch.zeros((r // 8, 8 * c), dtype=dt, device=dev)
            for r, c in zip(self._nrows, self.classes))
        self._linv = (tuple(torch.zeros((n, c, c), dtype=dt, device=dev)
                            for n, c in zip(self._npanels, self.classes))
                      if self._has_fast_solve else ())
        # Tinv and the aligned-operand slabs only where the plan has a top
        # or the pool is on
        self._tinv = (torch.zeros((self._top.t, self._top.t), dtype=dt,
                                  device=dev)
                      if self._top is not None else None)
        self._gp = ((tuple(tuple(torch.zeros(sh, dtype=dt, device=dev)
                                 for sh in seg)
                           for seg in self._gp_shapes[0]),
                     tuple(torch.zeros(sh, dtype=dt, device=dev)
                           for sh in self._gp_shapes[1]))
                    if self._gpool_enabled else ((), ()))
        self._b_in = torch.zeros(plan.n, dtype=dt, device=dev)
        self._x_out = torch.zeros(plan.n, dtype=dt, device=dev)
        #: ``_held`` keys: "pools", what the static pools hold; "prep_out",
        #: the solve_prep outputs (``_prep_flat``) the static Tinv, Linv
        #: pools and slabs hold; "prep", the pools whose triple
        #: ``solve_prep`` returned last (``_prep_out``); "top", the pools
        #: whose Tinv ``top_inverse`` returned last (``_top_out``)
        self._prep_static = self._prep_flat((self._tinv, self._linv,
                                             self._gp))
        self._init_programs(dev)
        self._prep_out = None
        self._top_out = None

    # ----------------------------------------------------------- tables
    def _map(self, m, ci, nsrc, name):
        """(pool position, source index) map, bounds-checked, as int64."""
        m = np.asarray(m, dtype=np.int64)
        size = self._nrows[ci] * self.classes[ci]
        if m.shape[1]:
            require(0 <= m[0].min() and m[0].max() < size,
                    f"{name} class {ci} position outside pool")
            require(0 <= m[1].min() and m[1].max() < nsrc,
                    f"{name} class {ci} source index outside values")
        return self._up(m[0], torch.int64), self._up(m[1], torch.int64)

    def _ar(self, k):
        """Cached device arange(k) (int64)."""
        if k not in self._iota:
            self._iota[k] = torch.arange(k, device=self.device)
        return self._iota[k]

    def _ingest(self, seg: SupSegment) -> _SegTables:
        n = self.plan.n
        T = seg.nsteps
        ws = [int(x) for x in seg.wslice]
        rlo = np.asarray(seg.rlo, dtype=np.int64).reshape(self.ncls, T)
        for ci in range(self.ncls):
            require(np.all(rlo[ci] >= 0)
                    and np.all(rlo[ci] + ws[ci] <= self._nrows[ci]),
                    f"class {ci} row window past the pool end")
        gsc = getattr(seg, "gsc", None)
        upd = []
        for b in seg.upd:
            a8 = _lanes_major(b.arow) // 8
            b8 = _lanes_major(b.brow) // 8
            rows8 = self._nrows[b.kcls] // 8
            require(a8.min(initial=0) >= 0
                    and a8.max(initial=0) + b.Mc // 8 <= rows8,
                    "update A-chunk gather past the pool end")
            require(b8.min(initial=0) >= 0
                    and b8.max(initial=0) + b.Q // 8 <= rows8,
                    "update B-operand gather past the pool end")
            colq = _lanes_major(b.colq)
            require(colq.min(initial=0) >= 0
                    and colq.max(initial=0) <= b.c,
                    "update column index outside the target width")
            dst = None
            if gsc is None:
                # with gather tables the plan's dst is never read (the JAX
                # executor does not upload it either)
                dst = _lanes_major(b.dst)
                require(dst.min(initial=0) >= 0
                        and dst.max(initial=0) <= ws[b.ccls],
                        "update delta row outside the window")
                dst = self._up(dst)
            upd.append(_UpdTables(a8=self._up(a8), b8=self._up(b8),
                                  colq=self._up(colq), dst=dst))
        gsc_t = None
        if gsc is not None:
            gsc_t = []
            for ci, ent in enumerate(gsc):
                if ent is None:
                    gsc_t.append(None)
                    continue
                ntot = sum(b.arow.shape[0] * b.arow.shape[2] * b.Mc
                           for b in seg.upd if b.ccls == ci)
                # splan casts source positions (+1) to int32 unchecked
                require(int(ent["ntot"]) == ntot and ntot + 1 < 2**31,
                        f"class {ci} gather table positions overflow "
                        f"int32 or disagree with the update buckets")
                nstack = 1
                for g in ent["gidx"]:
                    require(g.min(initial=0) >= 0
                            and g.max(initial=0) <= ntot,
                            f"class {ci} ladder gather outside the "
                            f"contribution rows")
                    nstack += g.shape[1]
                pidx = ent["pidx"]
                require(pidx.shape == (T, ws[ci])
                        and pidx.min(initial=0) >= 0
                        and pidx.max(initial=0) < nstack,
                        f"class {ci} window take outside the ladder sums")
                gsc_t.append(dict(gidx=[self._up(g) for g in ent["gidx"]],
                                  pidx=self._up(pidx)))
        fin = []
        for b in seg.fin:
            boff = np.asarray(b.boff, dtype=np.int64)
            require(np.all(boff >= 0)
                    and np.all(boff + b.P * b.H <= ws[b.ccls]),
                    "finalize bucket slice past the window end")
            require(np.all((b.w >= 0) & (b.w <= b.c)),
                    "finalize width outside the class width")
            require(b.H >= b.c and np.all((b.cnt >= 0) & (b.cnt <= b.P)),
                    "finalize bucket shorter than its width, or its lane "
                    "count outside [0, P]")
            require(np.all((b.cols0 >= 0) & (b.cols0 <= n))
                    and np.all((b.rows >= 0) & (b.rows <= n)),
                    "finalize column/row id outside [0, n]")
            fin.append(_FinTables(cnt=np.asarray(b.cnt, dtype=np.int64),
                                  boff=boff, w=self._up(b.w),
                                  cols0=self._up(b.cols0),
                                  rows=self._up(b.rows),
                                  sc=self._scatter_of(b)))
        # shared chol per class, batched in groups whose total lane count
        # keeps every (sumP, c, c) temp bounded (plan.fin_chol_elems)
        fin_groups, fin_fused = [], []
        for ci, c in enumerate(self.classes):
            mine = [k for k, b in enumerate(seg.fin) if b.ccls == ci]
            if self._fused_cls[ci]:
                fin_groups.append([])
                fin_fused.append(mine)
                continue
            fin_fused.append([])
            fin_groups.append(chol_groups(self.plan, seg, mine, c, 1))
        return _SegTables(rlo=rlo, upd=upd, fin=fin, gsc=gsc_t,
                          fin_groups=fin_groups, fin_fused=fin_fused)

    def _scatter_of(self, b, G=1, rank=0) -> _Scatter:
        """``solve_scatter_lists`` of finalize bucket ``b`` (the lanes of
        ``rank`` of G), checked and on the device: every position inside
        its block, every column and row in [0, n), so none is a pad."""
        n = self.plan.n
        cpos, ccol, coff, rpos, rrow, roff = solve_scatter_lists(
            b.w, b.cols0, b.rows, b.c, n, G, rank)
        require(cpos.size == 0 or (cpos.max() < b.P * b.c
                                   and 0 <= ccol.min()
                                   and ccol.max() < n),
                "solve column entry outside its block or [0, n)")
        require(rpos.size == 0 or (rpos.max() < b.P * b.H
                                   and 0 <= rrow.min()
                                   and rrow.max() < n),
                "solve row entry outside its block or [0, n)")
        return _Scatter(cpos=self._up(cpos), ccol=self._up(ccol, torch.int64),
                        coff=coff, rpos=self._up(rpos), rrow=self._up(rrow),
                        roff=roff)

    def _scatters(self, group=None) -> list:
        """Per segment, per finalize bucket: the ``_Scatter`` the leveled
        solves land with; with ``group`` its rank's lanes only, built at
        the group's first solve and kept."""
        if group is None:
            return [[ft.sc for ft in tabs.fin] for tabs in self._segs]
        key = (group.size, group.rank)
        if key not in self._rank_scatters:
            self._rank_scatters[key] = [
                [self._scatter_of(b, *key) for b in seg.fin]
                for seg in self.plan.segments]
        return self._rank_scatters[key]

    @property
    def solve_scatter_counts(self) -> dict:
        """Entries one ``solve_spd`` scatters (``landed``: each column
        once a direction, and each real row below a panel once) and
        entries it sends to a pad slot (``padded``: none, as the lists
        hold no pad)."""
        return {"landed": self._landed, "padded": 0}

    @property
    def chol_calls_per_factorize(self) -> int:
        """``chol_inverse`` calls one ``factorize`` makes (one per width
        class group per level step; fused classes make none)."""
        return sum(seg.nsteps * sum(len(g) for g in tabs.fin_groups)
                   for seg, tabs in zip(self.plan.segments, self._segs))

    @property
    def fused_calls_per_factorize(self) -> int:
        """``finalize_fused`` calls one ``factorize`` makes (one per
        finalize bucket of a fused class per level step)."""
        return sum(seg.nsteps * sum(len(k) for k in tabs.fin_fused)
                   for seg, tabs in zip(self.plan.segments, self._segs))

    def chol_batch_shapes(self) -> set:
        """Distinct (P, c) batch shapes ``factorize`` hands to
        ``chol_inverse``."""
        out = set()
        for seg, tabs in zip(self.plan.segments, self._segs):
            for ci, groups in enumerate(tabs.fin_groups):
                for grp in groups:
                    out.add((sum(seg.fin[k].P for k in grp),
                             self.classes[ci]))
        return out

    def _ingest_solve(self):
        """Tables of the pair-granular forward solve, every slot window,
        Linv-pool slice and gather bounds-checked (JAX clamps them)."""
        plan = self.plan
        n = plan.n
        npan = [int(x) for x in plan.npanels]
        self._npanels = npan
        self._bmap = []
        for ci, c in enumerate(self.classes):
            m = np.asarray(plan.bmap[ci], dtype=np.int64)
            if m.shape[1]:
                require(m[0].min() >= 0 and m[0].max() < npan[ci] * c,
                        f"bmap class {ci} position outside the xb pool")
                require(m[1].min() >= 0 and m[1].max() < n,
                        f"bmap class {ci} column outside [0, n)")
            self._bmap.append((self._up(m[0], torch.int64),
                               self._up(m[1], torch.int64)))
        require(plan.slotw is not None
                and all(np.shape(sw) == (npan[ci],)
                        and np.all((sw >= 0) & (sw <= c))
                        for ci, (sw, c) in enumerate(zip(plan.slotw,
                                                         self.classes))),
                "slot widths do not cover the slots or exceed the class")
        self._slotw = [self._up(sw) for sw in plan.slotw]
        self._ssegs = []
        for seg in plan.segments:
            T = seg.nsteps
            srlo = np.asarray(seg.srlo, dtype=np.int64).reshape(self.ncls, T)
            strue = np.asarray(seg.strue, dtype=np.int64).reshape(self.ncls,
                                                                  T)
            sw = [int(x) for x in seg.sslice]
            for ci in range(self.ncls):
                require(np.all(srlo[ci] >= 0)
                        and np.all(srlo[ci] + sw[ci] <= npan[ci]),
                        f"class {ci} slot window past the xb/Linv pool "
                        f"end")
                require(np.all((strue[ci] >= 0) & (strue[ci] <= sw[ci])),
                        f"class {ci} true slots outside the slot window")
            require(len(seg.soff) == len(seg.fin),
                    "one slot offset table per finalize bucket")
            soff = []
            for b, so in zip(seg.fin, seg.soff):
                so = np.asarray(so, dtype=np.int64)
                require(np.all(so >= 0)
                        and np.all(srlo[b.ccls] + so + b.P
                                   <= npan[b.ccls]),
                        "Linv pool slice past the pool end")
                soff.append(so)
            supd = []
            for b in seg.supd:
                supd.append(self._solve_upd(b, sw[b.ccls]))
            self._ssegs.append(_SolveTables(
                srlo=srlo, strue=strue, soff=soff, supd=supd,
                has_cls=[any(b.ccls == ci for b in seg.fin)
                         for ci in range(self.ncls)]))
        nseg = len(plan.segments)
        self._solve_nseg = (nseg if plan.solve_nseg is None
                            else int(plan.solve_nseg))
        require(0 <= self._solve_nseg <= nseg,
                "solve segment count outside [0, nseg]")
        if plan.top is not None:
            self._ingest_top(plan.top)
        # the aligned-operand pool: one (T, P*c*K) slab per update bucket
        # of the scanned segments, one (1, P*c*K) per top bucket; on when
        # its bytes fit the plan's budget (the JAX executor's f32 count)
        self._gp_shapes = (
            [[(seg.nsteps, b.brow.shape[1] * b.c * b.K) for b in seg.supd]
             for seg in plan.segments[:self._solve_nseg]],
            [(1, b.brow.shape[1] * b.c * b.K)
             for b in (plan.top.supd if plan.top is not None else [])])
        self._gpool_bytes = 4 * sum(
            T * w for part in self._gp_shapes[0] for T, w in part) + 4 * sum(
            w for _, w in self._gp_shapes[1])
        self._gpool_enabled = (self._gpool_bytes
                               <= getattr(plan, "gpool_mb", 2048) * 2**20)

    def _solve_upd(self, b, dst_max):
        """One solve-update bucket's tables, each gather bounds-checked;
        ``dst`` at most ``dst_max`` (the dummy slot row of a window, or the
        trash slot of a top bucket)."""
        npan = self._npanels
        b8 = np.asarray(b.brow, dtype=np.int64) // 8
        require(b8.min(initial=0) >= 0
                and b8.max(initial=0) + b.Q // 8
                <= self._nrows[b.kcls] // 8,
                "solve B-operand gather past the pool end")
        require(b.xrow.min(initial=0) >= 0
                and b.xrow.max(initial=0) < npan[b.kcls],
                "solve source slot outside the xb pool")
        require(b.colq.min(initial=0) >= 0
                and b.colq.max(initial=0) <= b.c,
                "solve column index outside the target width")
        require(b.dst.min(initial=0) >= 0
                and b.dst.max(initial=0) <= dst_max,
                "solve target slot outside the slot window")
        return _SolveUpdTables(b8=self._up(b8), xrow=self._up(b.xrow),
                               colq=self._up(b.colq), dst=self._up(b.dst))

    def _ingest_top(self, top):
        """The dense top's tables (``TopSolve``): T's gather from the pools
        as flat (row * c + col) pool positions, the xb map of its columns
        and its bottom-to-top update buckets, every index bounds-checked
        (JAX clamps them)."""
        t = int(top.t)
        require(t > 0 and len(top.gather) == self.ncls
                and len(top.xmap) == self.ncls,
                "dense top without columns or without a table per class")
        gather, xmap = [], []
        for ci, c in enumerate(self.classes):
            g = np.asarray(top.gather[ci], dtype=np.int64)
            if g.shape[1]:
                require(g[0].min() >= 0 and g[0].max() < self._nrows[ci]
                        and g[1].min() >= 0 and g[1].max() < c,
                        f"top gather class {ci} outside its pool")
                require(g[2].min() >= 0 and g[2].max() < t * t,
                        f"top gather class {ci} outside the t x t block")
            gather.append((self._up(g[0] * c + g[1], torch.int64),
                           self._up(g[2], torch.int64)))
            m = np.asarray(top.xmap[ci], dtype=np.int64)
            if m.shape[1]:
                require(m[0].min() >= 0
                        and m[0].max() < self._npanels[ci] * c,
                        f"top xmap class {ci} position outside the xb pool")
                require(m[1].min() >= 0 and m[1].max() < t,
                        f"top xmap class {ci} index outside [0, t)")
            xmap.append((self._up(m[0], torch.int64),
                         self._up(m[1], torch.int64)))
        supd = []
        for b in top.supd:
            require(np.shape(b.brow)[0] == 1,
                    "top update bucket with more than one step")
            # absolute slot targets; padded lanes land on the trash slot
            supd.append(self._solve_upd(b, self._npanels[b.ccls] - 1))
        self._top = top
        self._top_gather, self._top_xmap, self._top_supd = gather, xmap, supd

    # ------------------------------------------------------------- pools
    def _rows_view(self, pool, ci, start, rows):
        """(rows, c) row window [start, start+rows) of a packed pool, as a
        view (bounds checked at construction)."""
        return pool.view(-1, self.classes[ci])[start:start + rows]

    def _check_a(self, a_data):
        """``a_data`` as a tensor (where it lies), after its length check."""
        a = torch.as_tensor(a_data)
        if a.shape != (self._nnz_a,):
            raise ValueError(f"expected {self._nnz_a} A values, got "
                             f"{tuple(a.shape)}")
        return a

    def _init_pools(self, a, pools):
        """Zero the per-class packed pools and scatter A values into
        them."""
        with _scope("init"):
            for ci, p in enumerate(pools):
                pos, sel = self._a_map[ci]
                flat = p.view(-1)
                flat.zero_()
                flat.index_add_(0, pos, a[sel])

    def init_pools(self, a_data):
        """New per-class packed pools holding the A values and zeros, op by
        op (the counterpart of the JAX ``_init_pools_j``).  On a trisolve
        plan (``symbolic/strisolve.py``) the values are L's: the layout's
        map then places the given factor in the pools."""
        a = self._check_a(a_data).to(device=self.device, dtype=self.dtype)
        pools = tuple(torch.empty((r // 8, 8 * c), dtype=self.dtype,
                                  device=self.device)
                      for r, c in zip(self._nrows, self.classes))
        self._init_pools(a, pools)
        return pools

    # ---------------------------------------------------------- programs
    def _pools_out(self):
        """Clones of the static pools, which the next program overwrites;
        the static pools then hold them."""
        with _scope("executor.clone"):
            out = tuple(p.clone() for p in self._pools)
        self._hold("pools", out)
        return out

    def group_bounds(self, group: int) -> list:
        """The (first, end) segments of ``factorize_segmented``'s programs:
        the JAX executor's ``range(0, nseg, group)``."""
        group = int(group)
        if group < 1:
            raise ValueError(f"group {group} < 1")
        nseg = len(self.plan.segments)
        return [(lo, min(lo + group, nseg)) for lo in range(0, nseg, group)]

    def _chain(self, lo, hi, init=False):
        """Closure: with ``init`` the A values scattered into the zeroed
        static pools, then every level step of segments [lo, hi) on
        them."""
        def run():
            if init:
                self._init_pools(self._a_in, self._pools)
            for seg, tabs in zip(self.plan.segments[lo:hi],
                                 self._segs[lo:hi]):
                for t in range(seg.nsteps):
                    self._step(self._pools, seg, tabs, t)
        return run

    def _segments_program(self, lo, hi):
        return self._program(f"segments[{lo}:{hi}]", self._chain(lo, hi))

    # ----------------------------------------------------------- updates
    def _update_block(self, pools, b, ut: _UpdTables, t, lanes=slice(None)):
        """``update_block`` of one bucket at step t, (GP, Mc, c); only the
        ``lanes`` of the (G*P)-lane batch (one rank's shard)."""
        return update_block(pools[b.kcls], ut.a8[t][lanes],
                            ut.b8[t][lanes], ut.colq[t][lanes], b, self._ar,
                            self.dtype)

    def _apply_updates_gather(self, pools, wins, seg, tabs, t):
        """Scatter-free updates: contributions land through the plan's
        static ladder gathers and one dense window take
        (splan._build_gather_tables)."""
        cbuf = [[] for _ in self.classes]
        for b, ut in zip(seg.upd, tabs.upd):
            cbuf[b.ccls].append(
                self._update_block(pools, b, ut, t).reshape(-1, b.c))
        for ci, c in enumerate(self.classes):
            ent = tabs.gsc[ci]
            if ent is None:
                continue
            with _scope("upd.cat"):
                zero = torch.zeros((1, c), dtype=self.dtype,
                                   device=self.device)
                call = torch.cat([zero] + cbuf[ci])
            with _scope("upd.ladder"):
                parts = [zero] + [call[gi[t]].sum(dim=1)
                                  for gi in ent["gidx"]]
            with _scope("upd.take_sub"):
                wins[ci].sub_(torch.cat(parts)[ent["pidx"][t]])

    def _apply_updates(self, pools, wins, seg, tabs, t, group=None):
        """Batched update GEMMs row-added into per-class delta windows
        (one trailing dummy row takes the padding); one subtraction lands
        each on its window.  With ``group`` each rank runs its own shard
        of every bucket (lanes [rank*P, (rank+1)*P) of the G*P) and the
        class deltas are ``psum``'d (JAX: the ``axis_name`` branch; the
        gather tables are single-device only)."""
        if tabs.gsc is not None:
            if group is not None:
                raise ValueError("the gather update tables are "
                                 "single-device only")
            return self._apply_updates_gather(pools, wins, seg, tabs, t)
        with _scope("upd.take_sub"):
            deltas = [torch.zeros((seg.wslice[ci] + 1, c), dtype=self.dtype,
                                  device=self.device)
                      for ci, c in enumerate(self.classes)]
        for b, ut in zip(seg.upd, tabs.upd):
            lanes = slice(None)
            if group is not None:
                P = b.arow.shape[2]
                lanes = slice(group.rank * P, (group.rank + 1) * P)
            C = self._update_block(pools, b, ut, t, lanes)
            with _scope("upd.take_sub"):
                deltas[b.ccls].index_add_(0, ut.dst[t][lanes].reshape(-1),
                                          C.reshape(-1, b.c))
        if group is not None:
            for d in deltas:
                group.psum(d)
        with _scope("upd.take_sub"):
            for ci in range(self.ncls):
                wins[ci].sub_(deltas[ci][:seg.wslice[ci]])

    # ---------------------------------------------------------- finalize
    def _finalize(self, wins, seg, tabs, t, group=None, groups=None):
        """Per width class: the fused buckets, one ``finalize_fused`` each
        (single-device), then the unfused body over the chol groups:
        every bucket reads the pre-finalize window and adds a lane-masked
        diff to one class delta (real lanes never overlap across buckets
        and padded lanes' diffs are zero).  With ``group`` the rank takes
        its owner-strided lanes of the chol groups ``groups`` holds per
        class (``chol_groups`` at G)."""
        g, G = (group.rank, group.size) if group is not None else (0, 1)
        for ci in range(self.ncls):
            for k in tabs.fin_fused[ci]:
                x = fin_lanes(wins[ci], seg.fin[k], tabs.fin[k], t)
                x.blk += finalize_fused(x.blk, x.w, x.cnt)
            grps = (groups or tabs.fin_groups)[ci]
            if not grps:
                continue
            win = wins[ci]
            with _scope("fin.delta"):
                delta = torch.zeros_like(win)
            lanes = [[fin_lanes(win, seg.fin[k], tabs.fin[k], t, g, G)
                      for k in grp] for grp in grps]
            facs = fin_inverses(lanes, self.dtype)
            fin_land(win, delta, [x for grp in lanes for x in grp], facs,
                     group)

    # ------------------------------------------------------------ factor
    def _windows(self, pools, seg, tabs, t):
        """Each class's row window of step t, a view into its pool."""
        return [self._rows_view(pools[ci], ci, int(tabs.rlo[ci, t]),
                                seg.wslice[ci])
                for ci in range(self.ncls)]

    def _step(self, pools, seg, tabs, t, group=None, groups=None):
        """Level step t: the updates, then the finalize, on the windows;
        with ``group`` (and its ``groups``, see ``_finalize``) as one rank
        of the sharded tier (``parallel/sharded.py``)."""
        wins = self._windows(pools, seg, tabs, t)
        self._apply_updates(pools, wins, seg, tabs, t, group)
        self._finalize(wins, seg, tabs, t, group, groups)

    def _load_a(self, a_data):
        """Copy the A values into the static input, outside any program:
        host to device from numpy, device to device from a CUDA tensor."""
        with _scope("executor.load"):
            self._a_in.copy_(self._check_a(a_data))

    def factorize(self, a_data):
        """Numeric supernodal Cholesky: A values (permuted lower CSC data,
        numpy or a tensor) -> per-class packed panel pools (a tuple of
        tensors on the executor's device).  The counterpart of the JAX
        executor's ``_factorize`` jit: one program runs every segment, and
        the pools it leaves are returned as clones, which no later call
        overwrites."""
        return self.factorize_loop(a_data, 1)

    def _factorize_eager(self, a_data):
        """``factorize`` run op by op on fresh pools, outside the programs
        and their static tensors: the reference they are held against."""
        pools = self.init_pools(a_data)
        for seg, tabs in zip(self.plan.segments, self._segs):
            for t in range(seg.nsteps):
                self._step(pools, seg, tabs, t)
        return pools

    def factorize_segmented(self, a_data, group: int = 8):
        """``factorize`` as one program per ``group`` consecutive segments
        (``group_bounds``) after one that scatters the A values, updating
        the static pools in place (the JAX executor donates them).  The
        counterpart of the JAX ``factorize_segmented``; the programs are
        kept per segment range, so each grouping captures once.  JAX's
        ``cache_dir`` (a cache of compiled TPU executables) has no
        counterpart."""
        bounds = self.group_bounds(group)
        self._load_a(a_data)
        self._program("init", self._chain(0, 0, init=True)).run()
        for lo, hi in bounds:
            self._segments_program(lo, hi).run()
        return self._pools_out()

    def factorize_loop(self, a_data, iters: int):
        """``iters`` runs of ``factorize``'s program with no host sync in
        between; returns the last pools.  The counterpart of the JAX
        ``factorize_loop``, whose fold-proof select only keeps XLA from
        collapsing the loop: a replayed graph is not simplified, so there
        is none here."""
        iters = int(iters)
        if iters < 1:
            raise ValueError(f"iters {iters} < 1")
        self._load_a(a_data)
        prog = self._program("factorize",
                             self._chain(0, len(self._segs), init=True))
        for _ in range(iters):
            prog.run()
        return self._pools_out()

    # ------------------------------------------------------------ solves
    def _panel_blk(self, pools, b, ft, rlo, t):
        start = int(rlo[b.ccls, t]) + int(ft.boff[t])
        return self._rows_view(pools[b.ccls], b.ccls, start,
                               b.P * b.H).view(b.P, b.H, b.c)

    def _inv_blk(self, blk, w, c):
        """The diag block's triangular inverse from the pool
        (``inv_blk``)."""
        return inv_blk(blk, w, self._ar(c))

    def _own_mask(self, P, group):
        """(P, 1) bool: the bucket lanes this rank of ``group`` solves,
        lane % G == rank (the finalize's owner striding)."""
        return (self._ar(P) % group.size == group.rank)[:, None]

    def _diag_tri(self, blk, w, c):
        """The solve-ready lower triangle of a factored panel top: the
        valid w x w lower part, identity on the padded diagonal so that
        the inverse exists."""
        ar = self._ar(c)
        i = ar[None, :, None]
        j = ar[None, None, :]
        wv = w[:, None, None]
        D = blk[:, :c, :].masked_fill(~((i < wv) & (j < wv) & (j <= i)), 0)
        return D + ((i == j) & (i >= wv)).to(self.dtype)

    def _prepare_solve_impl(self, pools):
        """Write Linv^T into the strict upper triangle of every panel's
        diagonal block, in place, bucket after bucket as the JAX scan
        does; the lower triangle keeps the pools' own values.  For
        factors loaded as values (the blocked ``TriangularSolver``):
        ``factorize`` stores Linv^T itself."""
        for seg, tabs in zip(self.plan.segments, self._segs):
            for t in range(seg.nsteps):
                for b, ft in zip(seg.fin, tabs.fin):
                    c = b.c
                    blk = self._panel_blk(pools, b, ft, tabs.rlo, t)
                    w = ft.w[t]
                    Linv = dense.nilpotent_inv(self._diag_tri(blk, w, c))
                    ar = self._ar(c)
                    i = ar[None, :, None]
                    j = ar[None, None, :]
                    wv = w[:, None, None]
                    blk[:, :c, :] += Linv.transpose(1, 2).masked_fill(
                        ~((j > i) & (i < wv) & (j < wv)), 0)

    def prepare_solve_pools(self, pools):
        """Pools with the stored inverses the solves read, from a factor
        loaded as values (``init_pools``): one program (the counterpart of
        the JAX ``_prepare_solve`` jit) on the static pools, returned as
        clones."""
        self._load("pools", self._pools, pools)
        self._program("prepare_solve",
                      lambda: self._prepare_solve_impl(self._pools)).run()
        return self._pools_out()

    def _check_vec(self, b):
        b = torch.as_tensor(b)
        if b.shape != (self.plan.n,):
            raise ValueError(f"expected a vector of {self.plan.n}, got "
                             f"{tuple(b.shape)}")
        return b

    def _vec(self, b):
        return self._check_vec(b).to(device=self.device, dtype=self.dtype)

    def _solve_lower_impl(self, pools, b_vec, group=None):
        """Forward substitution over the wavefront schedule.  Each bucket
        lands only its real entries (``_Scatter``): x at its columns, and
        the right-hand-side updates at its rows below, through one delta
        per level step.  With ``group`` each rank solves its owner-strided
        lanes into a dense x delta too, and one ``psum`` of each delta per
        level step merges the ranks (JAX: the ``axis_name`` branch)."""
        with _scope("slv.lower"):
            n = self.plan.n
            zero1 = torch.zeros(1, dtype=self.dtype, device=self.device)
            # slot n stays zero: the gathers below read it for pad lanes
            x = torch.zeros(n + 1, dtype=self.dtype, device=self.device)
            bc = torch.cat([b_vec, zero1])
            for seg, tabs, scs in zip(self.plan.segments, self._segs,
                                      self._scatters(group)):
                for t in range(seg.nsteps):
                    dx = x if group is None else torch.zeros_like(x)
                    dbc = torch.zeros_like(bc)
                    for b, ft, sc in zip(seg.fin, tabs.fin, scs):
                        blk = self._panel_blk(pools, b, ft, tabs.rlo, t)
                        w = ft.w[t]
                        Linv = self._inv_blk(blk, w, b.c)
                        arc = self._ar(b.c)
                        cidx = torch.clamp(ft.cols0[t][:, None] + arc, max=n)
                        # the mask: a real lane's pad columns read the next
                        # panel's columns
                        colv = arc[None, :] < w[:, None]
                        if group is not None:
                            colv = colv & self._own_mask(b.P, group)
                        # Linv's rows past w are zero, so xs_ is zero there
                        xs_ = torch.bmm(Linv, (bc[cidx] * colv)[:, :, None])
                        sc.land_cols(dx, xs_, t)
                        sc.sub_rows(dbc, torch.bmm(blk, xs_), t)
                    if group is not None:
                        x = x + group.psum(dx)
                        group.psum(dbc)
                    bc = bc + dbc
            return x[:n]

    def _solve_upper_impl(self, pools, b_vec, group=None):
        """Backward substitution: the schedule in reverse, x landed at each
        bucket's real columns (``_Scatter``).  With ``group`` each rank
        solves its owner-strided lanes into a dense x delta, and one
        ``psum`` of it per level step merges them."""
        with _scope("slv.upper"):
            n = self.plan.n
            zero1 = torch.zeros(1, dtype=self.dtype, device=self.device)
            # slot n stays zero: the gathers below read it for pad rows
            x = torch.zeros(n + 1, dtype=self.dtype, device=self.device)
            bp = torch.cat([b_vec, zero1])
            for seg, tabs, scs in zip(reversed(self.plan.segments),
                                      reversed(self._segs),
                                      reversed(self._scatters(group))):
                for t in reversed(range(seg.nsteps)):
                    # same-level panels read no column of one another, so
                    # x takes each bucket's columns at once
                    dx = x if group is None else torch.zeros_like(x)
                    for b, ft, sc in zip(seg.fin, tabs.fin, scs):
                        blk = self._panel_blk(pools, b, ft, tabs.rlo, t)
                        w = ft.w[t]
                        Linv = self._inv_blk(blk, w, b.c)
                        below = self._ar(b.H)[None, :] >= w[:, None]
                        xr = x[ft.rows[t]] * below
                        tt = torch.bmm(blk.transpose(1, 2),
                                       xr[:, :, None])[:, :, 0]
                        arc = self._ar(b.c)
                        cidx = torch.clamp(ft.cols0[t][:, None] + arc, max=n)
                        colv = arc[None, :] < w[:, None]
                        if group is not None:
                            colv = colv & self._own_mask(b.P, group)
                        rhs = (bp[cidx] - tt) * colv
                        sc.land_cols(dx, torch.bmm(Linv.transpose(1, 2),
                                                   rhs[:, :, None]), t)
                    if group is not None:
                        x = x + group.psum(dx)
            return x[:n]

    def _linv_pools(self, pools, linv=None):
        """Slot-ordered per-class pools of diag-block inverses:
        linv[ci][slot] = Linv of the panel at that slot, so that every
        step of the fast solve takes one contiguous slice and one batched
        product per class.  Built in ``linv`` (zeroed first) when given,
        else in new tensors."""
        if linv is None:
            linv = [torch.zeros((self._npanels[ci], c, c), dtype=self.dtype,
                                device=self.device)
                    for ci, c in enumerate(self.classes)]
        else:
            for x in linv:
                x.zero_()
        for seg, tabs, st in zip(self.plan.segments, self._segs,
                                 self._ssegs):
            for t in range(seg.nsteps):
                for k, (b, ft) in enumerate(zip(seg.fin, tabs.fin)):
                    blk = self._panel_blk(pools, b, ft, tabs.rlo, t)
                    so = int(st.srlo[b.ccls, t]) + int(st.soff[k][t])
                    # add (not set): a bucket's padded lanes (inverse 0)
                    # overlap the next level's slots
                    linv[b.ccls][so:so + b.P] += self._inv_blk(
                        blk, ft.w[t], b.c)
        return tuple(linv)

    def _top_dense(self, pools):
        """The dense top's (t, t) lower-triangular block T, gathered from
        the pools: the lower triangle of every L value among the top's
        columns (the strict upper triangles of the diagonal blocks hold
        stored inverses and are never gathered)."""
        t = self._top.t
        Td = torch.zeros(t * t, dtype=self.dtype, device=self.device)
        for pool, (src, dst) in zip(pools, self._top_gather):
            Td[dst] = pool.reshape(-1)[src]
        return Td.view(t, t)

    def _top_inverse_impl(self, pools):
        """Tinv = T^{-1} (``dense.dense_tri_inv``)."""
        return dense.dense_tri_inv(self._top_dense(pools))

    def top_inverse(self, pools):
        """Explicit inverse of the dense top's triangular block, from the
        factored pools, by one program on the static pools; a clone, cached
        on the pools' identity and version counters.  A plan without a top
        gives a (0, 0) tensor, as in the JAX executor."""
        if self._top is None:
            return torch.zeros((0, 0), dtype=self.dtype, device=self.device)
        pools = tuple(pools)
        if self._holds("top", pools):
            return self._top_out
        self._load("pools", self._pools, pools)
        self._program("top_inverse", lambda: self._tinv.copy_(
            self._top_inverse_impl(self._pools))).run()
        # the static Tinv no longer holds solve_prep's
        self._held.pop("prep_out", None)
        self._top_out = self._tinv.clone()
        self._hold("top", pools)
        return self._top_out

    def _gpool_block(self, pools, b, su):
        """Aligned-operand slab of one solve-update bucket: per pair and
        step the column-aligned overlap block G = S @ B_raw (c, K), S the
        one-hot alignment from ``colq``, as (T, P*c*K)."""
        T, P = su.b8.shape
        Braw = pools[b.kcls][
            su.b8.reshape(-1)[:, None] + self._ar(b.Q // 8)
        ].reshape(-1, b.Q, b.K)
        S = (self._ar(b.c)[None, :, None]
             == su.colq.reshape(-1, 1, b.Q)).to(self.dtype)
        return torch.bmm(S, Braw).view(T, P * b.c * b.K)

    def _gpool_impl(self, pools, gp):
        """Fill the aligned-operand pool ``gp`` (``self._gp``'s layout):
        per scanned segment and update bucket a (T, P*c*K) slab, per top
        bucket a (1, P*c*K) one, so that every solve step reads one slab
        in place of an index gather and a one-hot product."""
        for seg, st, slabs in zip(self.plan.segments, self._ssegs, gp[0]):
            for b, su, g in zip(seg.supd, st.supd, slabs):
                g.copy_(self._gpool_block(pools, b, su))
        if self._top is not None:
            for b, su, g in zip(self._top.supd, self._top_supd, gp[1]):
                g.copy_(self._gpool_block(pools, b, su))

    def _prep_flat(self, triple):
        """The tensors of a ``solve_prep`` triple in the static tensors'
        order: Tinv where the plan has a top, the Linv pools, the slabs
        where the pool is on."""
        tinv, linv, gp = triple
        return (((tinv,) if self._top is not None else ()) + tuple(linv)
                + tuple(g for slabs in gp[0] for g in slabs) + tuple(gp[1]))

    def solve_prep(self, pools):
        """(tinv, linv, gp) for the fast forward solve, built once per
        factorization by one program on the static tensors (the JAX
        executor's ``top_inverse``, ``_linv_pools_j`` and ``_gpool_j``):
        Tinv (a (0, 0) tensor without a top), the slot-ordered Linv pools,
        and the aligned-operand pool ``(segments, top)`` (``((), ())``
        when it is off).  Returned as clones, so that each factor keeps
        its own; cached on the pools' identity and version counters, so
        new pools or pools changed in place rebuild it."""
        pools = tuple(pools)
        if self._holds("prep", pools):
            return self._prep_out
        self._load("pools", self._pools, pools)

        def prep():
            self._linv_pools(self._pools, self._linv)
            if self._top is not None:
                self._tinv.copy_(self._top_inverse_impl(self._pools))
            if self._gpool_enabled:
                self._gpool_impl(self._pools, self._gp)
        self._program("solve_prep", prep).run()
        tinv = (self._tinv.clone() if self._top is not None
                else torch.zeros((0, 0), dtype=self.dtype,
                                 device=self.device))
        linv = tuple(x.clone() for x in self._linv)
        gp = (tuple(tuple(g.clone() for g in slabs) for slabs in self._gp[0]),
              tuple(g.clone() for g in self._gp[1]))
        self._prep_out = (tinv, linv, gp)
        self._hold("prep_out", self._prep_flat(self._prep_out))
        self._hold("prep", pools)
        return self._prep_out

    def _aligned(self, pools, b, su, t, xsrc, slab=None):
        """(P, c): the rows y = L_overlap x_src of one solve-update
        bucket's pairs at step t, aligned to the target panel's columns:
        from the pair's slab of the aligned-operand pool when given
        (``slab``, (T, P*c*K)), else by gathering the B operand from the
        pools and one one-hot product."""
        if slab is not None:
            G = slab[t].view(-1, b.c, b.K)
            return torch.bmm(G, xsrc[:, :, None])[:, :, 0]
        Braw = pools[b.kcls][
            su.b8[t][:, None] + self._ar(b.Q // 8)
        ].reshape(-1, b.Q, b.K)
        y = torch.bmm(Braw, xsrc[:, :, None])                   # (P, Q, 1)
        S = (self._ar(b.c)[None, :, None]
             == su.colq[t][:, None, :]).to(self.dtype)
        return torch.bmm(S, y)[:, :, 0]

    def _solve_lower_fast_impl(self, pools, b_vec, tinv, linv, gp):
        """Forward substitution with the right-hand side in panel-column
        layout (xb pools: one c-wide row per panel slot).  Per level step
        each update pair lands one column-aligned row
        y = L_overlap x_src on its target slot, and each class then takes
        one slice of the Linv pool and one batched product for its
        diagonal solves.  The counterpart of the JAX executor's
        ``_solve_lower_fast_impl``: with a dense top the level steps stop
        at ``solve_nseg``, the top's update buckets land from below, and
        one product with ``tinv`` solves the top's columns; with the
        aligned-operand pool on, each pair reads its slab of ``gp``."""
        with _scope("slv.lower"):
            n = self.plan.n
            xb = []
            for ci, c in enumerate(self.classes):
                pos, sel = self._bmap[ci]
                flat = torch.zeros(self._npanels[ci] * c, dtype=self.dtype,
                                   device=self.device)
                flat[pos] = b_vec[sel]
                xb.append(flat.view(-1, c))
            for si in range(self._solve_nseg):
                seg, st = self.plan.segments[si], self._ssegs[si]
                slabs = gp[0][si] if self._gpool_enabled else [None] * len(
                    seg.supd)
                for t in range(seg.nsteps):
                    # every operand is gathered (copied) before any slot
                    # window of this step is written
                    deltas = [None] * self.ncls
                    for b, su, g in zip(seg.supd, st.supd, slabs):
                        C = self._aligned(pools, b, su, t,
                                          xb[b.kcls][su.xrow[t]], g)
                        if deltas[b.ccls] is None:
                            deltas[b.ccls] = torch.zeros(
                                (seg.sslice[b.ccls] + 1, b.c),
                                dtype=self.dtype, device=self.device)
                        deltas[b.ccls].index_add_(0, su.dst[t], C)
                    for ci, c in enumerate(self.classes):
                        Sw = seg.sslice[ci]
                        lo = int(st.srlo[ci, t])
                        win = xb[ci][lo:lo + Sw]
                        if deltas[ci] is not None:
                            win.sub_(deltas[ci][:Sw])
                        # the level's slots are the run [0, strue) of the
                        # window; rows beyond keep their updated values
                        ntrue = int(st.strue[ci, t])
                        if not st.has_cls[ci] or ntrue == 0:
                            continue
                        colv = (self._ar(c)[None, :]
                                < self._slotw[ci][lo:lo + ntrue, None]
                                ).to(self.dtype)
                        win[:ntrue] = torch.bmm(
                            linv[ci][lo:lo + ntrue],
                            (win[:ntrue] * colv)[:, :, None])[:, :, 0] * colv
            if self._top is not None:
                # the bottom-to-top updates, bucket after bucket, then the top
                # columns' right-hand side through one product with Tinv
                slabs = gp[1] if self._gpool_enabled else [None] * len(
                    self._top_supd)
                for b, su, g in zip(self._top.supd, self._top_supd, slabs):
                    C = self._aligned(pools, b, su, 0,
                                      xb[b.kcls][su.xrow[0]], g)
                    xb[b.ccls].index_add_(0, su.dst[0], C, alpha=-1)
                rhs = torch.zeros(self._top.t, dtype=self.dtype,
                                  device=self.device)
                for ci, (pos, idx) in enumerate(self._top_xmap):
                    rhs[idx] = xb[ci].reshape(-1)[pos]
                xt = torch.mv(tinv, rhs)
                for ci, (pos, idx) in enumerate(self._top_xmap):
                    xb[ci].view(-1)[pos] = xt[idx]
            out = torch.zeros(n, dtype=self.dtype, device=self.device)
            for ci in range(self.ncls):
                pos, sel = self._bmap[ci]
                out[sel] = xb[ci].reshape(-1)[pos]
            return out

    def _solve(self, name, pools, b, iters=1):
        """Run the solve program ``name`` ``iters`` times on ``pools`` and
        ``b`` (copied into the static tensors unless they hold them) and
        return a clone of its x."""
        if name == "solve_lower_fast":
            self._load("prep_out", self._prep_static,
                       self._prep_flat(self.solve_prep(pools)))
        with _scope("executor.load"):
            self._load("pools", self._pools, pools)
            self._b_in.copy_(self._check_vec(b))
        P, bv = self._pools, self._b_in
        impl = {
            "solve_lower_fast": lambda: self._solve_lower_fast_impl(
                P, bv, self._tinv, self._linv, self._gp),
            "solve_lower": lambda: self._solve_lower_impl(P, bv),
            "solve_upper": lambda: self._solve_upper_impl(P, bv),
            "solve_spd": lambda: self._solve_upper_impl(
                P, self._solve_lower_impl(P, bv)),
        }[name]
        prog = self._program(name, lambda: self._x_out.copy_(impl()))
        for _ in range(iters):
            prog.run()
        with _scope("executor.clone"):
            return self._x_out.clone()

    def _lower_name(self):
        return ("solve_lower_fast" if self._has_fast_solve
                else "solve_lower")

    def solve_lower(self, pools, b):
        """x = L^{-1} b (forward substitution, level-parallel): the
        pair-granular fast solve when the plan carries its tables (after
        ``solve_prep``), else the leveled one.  One program, as each
        solve below."""
        return self._solve(self._lower_name(), pools, b)

    def solve_upper(self, pools, b):
        """x = L^{-T} b (backward substitution)."""
        return self._solve("solve_upper", pools, b)

    def solve_spd(self, pools, b):
        """x = (L L^T)^{-1} b, through the leveled forward solve (as the
        JAX executor's ``solve_spd``)."""
        return self._solve("solve_spd", pools, b)

    def solve_loop(self, pools, b, iters: int):
        """``solve_prep`` once, then ``iters`` runs of the forward solve's
        program (the fast one when the plan has its tables, else the
        leveled one) with no host sync in between; returns the last x.
        The counterpart of the JAX ``solve_loop`` without its fold-proof
        select (see ``factorize_loop``) and its ``cache_dir``."""
        iters = int(iters)
        if iters < 1:
            raise ValueError(f"iters {iters} < 1")
        return self._solve(self._lower_name(), pools, b, iters)

    # --------------------------------------------------------- profiling
    def profile_segments(self, a_data, iters: int = 3,
                         reps: int = 20) -> list[dict]:
        """Per-segment times, the counterpart of the JAX
        ``profile_segments`` (reference: the instrumented executors behind
        TIMING/ANALYZE_THEORY, Cholesky_Perf_Modeling.h:29), with its
        records, on ``factorize_segmented``'s segments at ``group=1``.

        Segment i is timed on pools factored through segment i-1, as
        ``SegmentTimer`` times a program: each run first restores the rows
        the segment's steps write, then runs the segment; ``reps`` runs
        back to back, ``iters`` times, in turns with a restore-only program
        whose median is subtracted.  ``median_s``
        is per run: device time between CUDA events on the card (after a
        device sleep that lets the host enqueue the runs first), host time
        on the CPU.  The JAX executor instead runs the segment again on its
        own output, which leaves NaN in the pools: on the card such runs
        take the time of real ones in the same turns, but that protocol's
        times missed the restored ones by more than 5 % in some segment
        (``tools/segment_protocols.py``, PERF.md §7)."""
        timer = SegmentTimer(self, a_data, "profile_segments", int(iters),
                             int(reps))
        out = []
        for lo, hi in self.group_bounds(1):
            seg = self.plan.segments[lo]
            timer.begin(lo)
            prog = timer.program("segment", self._chain(lo, hi))
            times, _ = timer.time({"segment": prog})
            prog.run()      # the pools then hold the next segment's input
            out.append({"segment": lo, "steps": seg.nsteps,
                        "upd_buckets": len(seg.upd),
                        "fin_buckets": len(seg.fin),
                        "wslice": list(seg.wslice),
                        "median_s": times["segment"]})
        return out

    # ------------------------------------------------------------ export
    def factor_values(self, pools):
        """Values of the simplicial L pattern extracted from the pools
        (verification path)."""
        if self._l_map is None:
            self._l_map = [self._map(m, ci, self._nnz_l, "l_map")
                           for ci, m in enumerate(self.plan.layout.l_map)]
        out = torch.zeros(self._nnz_l, dtype=self.dtype, device=self.device)
        for ci in range(self.ncls):
            pos, sel = self._l_map[ci]
            out[sel] = pools[ci].reshape(-1)[pos]
        return out


# ------------------------------------------------------- segment timing
#: device clock cycles slept per timed run before the start event: about
#: 100 µs at the H100's ~2 GHz, more than the host takes to enqueue a replay
_SLEEP_CYCLES = 200_000


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reps_s(device, fn, reps):
    """Seconds of ``reps`` back-to-back calls of ``fn``."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda._sleep(reps * _SLEEP_CYCLES)

    def run():
        for _ in range(reps):
            fn()
    return graphs.elapsed_s(device, run)


class SegmentTimer:
    """The restore-and-time protocol of ``profile_segments`` and the
    attribution scripts on the static pools of ``ex``.  ``begin(i)`` saves
    segment i's input rows (the pools must then hold segment i's input);
    ``program`` makes a mode's program ``<name>:<mode>[<segment>]``, which
    restores those rows and runs the mode's variant of the steps; ``time``
    times a segment's programs, ``reps`` runs back to back, ``iters``
    times, in turns with a restore-only program whose median is
    subtracted.  A run of the program of the segment's real steps leaves
    the next segment's input.  Each run restores its input because a
    finalize applied to a block it has already factored can hand K1 a
    block that is not SPD, which K1 turns into NaN
    (``scripts/attribution.reps_on_own_output``)."""

    def __init__(self, ex, a_data, name, iters, reps):
        if iters < 1 or reps < 1:
            raise ValueError(f"iters {iters} and reps {reps} must be >= 1")
        self.ex, self.name, self.iters, self.reps = ex, name, iters, reps
        ex._load_a(a_data)
        ex._program("init", ex._chain(0, 0, init=True)).run()
        # the static pools no longer hold a returned factor
        ex._held.pop("pools", None)
        self.seg = None

    def rows(self, i):
        """Per class (class, first row, rows): the union of segment i's
        row windows, which hold every pool entry its steps write."""
        ex = self.ex
        seg, rlo = ex.plan.segments[i], ex._segs[i].rlo
        out = []
        for ci in range(ex.ncls):
            w = int(seg.wslice[ci])
            if w:
                lo = int(rlo[ci].min())
                out.append((ci, lo, int(rlo[ci].max()) + w - lo))
        return out

    def begin(self, i):
        """Save segment i's input rows and make its restore closure."""
        ex = self.ex
        pairs = []
        for ci, lo, n in self.rows(i):
            view = ex._rows_view(ex._pools[ci], ci, lo, n)
            pairs.append((view, view.clone()))

        def restore():
            for dst, src in pairs:
                dst.copy_(src)
        self.seg, self._restore = i, restore

    def program(self, mode, body):
        """The program ``<name>:<mode>[<segment>]``: restore, then
        ``body()``."""
        restore = self._restore

        def run():
            restore()
            body()
        return self.ex._program(f"{self.name}:{mode}[{self.seg}]", run)

    def time(self, progs: dict):
        """({mode: seconds per run, restore subtracted}, restore seconds)
        of the current segment's ``progs``, each captured first."""
        ex = self.ex
        allp = dict(progs)
        allp[None] = ex._program(f"{self.name}:restore[{self.seg}]",
                                 self._restore)
        for p in allp.values():
            p.run()
        samples = {m: [] for m in allp}
        for _ in range(self.iters):
            for m, p in allp.items():
                samples[m].append(_reps_s(ex.device, p.run, self.reps))
        med = {m: sorted(v)[len(v) // 2] / self.reps
               for m, v in samples.items()}
        return {m: med[m] - med[None] for m in progs}, med[None]
