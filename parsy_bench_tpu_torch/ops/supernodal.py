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
  class (reference: H2LeveledBlockedLsolve, Triangular_BCSC.h:171);
* ``solve_upper`` / ``solve_spd`` — leveled blocked solves over the same
  wavefront schedule (``solve_spd`` runs the leveled forward solve, as the
  JAX executor's does).

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
* plans with a dense top (``dense_top_cols``) or the aligned-operand pool
  (``solve_gpool_mb``), both off by default, raise NotImplementedError;
* row windows are views into the pools and are updated in place.  Each
  phase of a step (updates, then finalize) finishes all of its reads
  before its one write per class, which is what the JAX copies give; the
  fused finalize and the fast solve's slot windows likewise gather every
  operand of a step before they write.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from parsy_bench_tpu_torch.ops import dense, kernels
from parsy_bench_tpu_torch.symbolic.splan import SupernodalPlan, SupSegment

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def torch_dtype(dtype) -> torch.dtype:
    """A torch float dtype from a name, numpy dtype or torch dtype."""
    if isinstance(dtype, torch.dtype):
        if dtype in _DTYPES.values():
            return dtype
    else:
        name = np.dtype(dtype).name
        if name in _DTYPES:
            return _DTYPES[name]
    raise ValueError(f"unsupported dtype {dtype!r}: float32 or float64")


def resolve_device(device) -> torch.device:
    """The torch device the caller named; raises when it is a CUDA device
    on a machine without CUDA (there is no CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is "
                               f"not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: cpu or cuda")
    return dev


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


def _require(ok, msg):
    if not ok:
        raise ValueError(f"plan out of bounds: {msg}")


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


@dataclasses.dataclass
class _FinTables:
    cnt: np.ndarray           # (T,) host: true lanes per step
    boff: np.ndarray          # (T,) host: window-local slice offset
    w: torch.Tensor           # (T, P) logical widths
    cols0: torch.Tensor       # (T, P) first global column; pad -> n
    rows: torch.Tensor        # (T, P, H) global rows; pad -> n


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


class SupernodalExecutor:
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
        if plan.top is not None:
            raise NotImplementedError(
                "plan with a dense top (dense_top_cols > 0): top_inverse "
                "and dense_tri_inv are a later port (ROADMAP §1, item 2)")
        if plan.gpool_mb > 0:
            raise NotImplementedError(
                "plan with the aligned-operand pool (solve_gpool_mb > 0): "
                "_gpool_impl is a later port (ROADMAP §1, item 3)")
        if (self.device.type == "cuda"
                and torch.backends.cuda.matmul.allow_tf32):
            raise RuntimeError(
                "torch.backends.cuda.matmul.allow_tf32 is True: TF32 "
                "products cost ~1e-3 in the factor; set it to False")
        lay = plan.layout
        self.ncls = lay.ncls
        self.classes = tuple(int(c) for c in lay.classes)
        self.fused_finalize = bool(fused_finalize)
        self._fused_cls = [self.fused_finalize and c <= FUSED_MAX_WIDTH
                           for c in self.classes]
        self._nrows = [int(r) for r in plan.nrows]
        for ci, r in enumerate(self._nrows):
            _require(r % 8 == 0, f"class {ci} pool rows {r} not packed")
        #: bytes of index tables held on the device
        self.table_bytes = 0
        self._nnz_a = int(sum(m.shape[1] for m in lay.a_map))
        self._nnz_l = int(lay.nnz_l)
        self._a_map = [self._map(m, ci, self._nnz_a, "a_map")
                       for ci, m in enumerate(lay.a_map)]
        self._l_map = None
        self._iota = {}
        self._segs = [self._ingest(seg) for seg in plan.segments]
        self._has_fast_solve = (
            plan.bmap is not None
            and all(seg.srlo is not None for seg in plan.segments))
        if self._has_fast_solve:
            self._ingest_solve()
        self._solve_prep_cache = None

    # ----------------------------------------------------------- tables
    def _up(self, arr, dtype=torch.int32):
        t = torch.as_tensor(np.ascontiguousarray(arr)).to(
            device=self.device, dtype=dtype)
        self.table_bytes += t.numel() * t.element_size()
        return t

    def _map(self, m, ci, nsrc, name):
        """(pool position, source index) map, bounds-checked, as int64."""
        m = np.asarray(m, dtype=np.int64)
        size = self._nrows[ci] * self.classes[ci]
        if m.shape[1]:
            _require(0 <= m[0].min() and m[0].max() < size,
                     f"{name} class {ci} position outside pool")
            _require(0 <= m[1].min() and m[1].max() < nsrc,
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
            _require(np.all(rlo[ci] >= 0)
                     and np.all(rlo[ci] + ws[ci] <= self._nrows[ci]),
                     f"class {ci} row window past the pool end")
        gsc = getattr(seg, "gsc", None)
        upd = []
        for b in seg.upd:
            a8 = _lanes_major(b.arow) // 8
            b8 = _lanes_major(b.brow) // 8
            rows8 = self._nrows[b.kcls] // 8
            _require(a8.min(initial=0) >= 0
                     and a8.max(initial=0) + b.Mc // 8 <= rows8,
                     "update A-chunk gather past the pool end")
            _require(b8.min(initial=0) >= 0
                     and b8.max(initial=0) + b.Q // 8 <= rows8,
                     "update B-operand gather past the pool end")
            colq = _lanes_major(b.colq)
            _require(colq.min(initial=0) >= 0
                     and colq.max(initial=0) <= b.c,
                     "update column index outside the target width")
            dst = None
            if gsc is None:
                # with gather tables the plan's dst is never read (the JAX
                # executor does not upload it either)
                dst = _lanes_major(b.dst)
                _require(dst.min(initial=0) >= 0
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
                _require(int(ent["ntot"]) == ntot and ntot + 1 < 2**31,
                         f"class {ci} gather table positions overflow "
                         f"int32 or disagree with the update buckets")
                nstack = 1
                for g in ent["gidx"]:
                    _require(g.min(initial=0) >= 0
                             and g.max(initial=0) <= ntot,
                             f"class {ci} ladder gather outside the "
                             f"contribution rows")
                    nstack += g.shape[1]
                pidx = ent["pidx"]
                _require(pidx.shape == (T, ws[ci])
                         and pidx.min(initial=0) >= 0
                         and pidx.max(initial=0) < nstack,
                         f"class {ci} window take outside the ladder sums")
                gsc_t.append(dict(gidx=[self._up(g) for g in ent["gidx"]],
                                  pidx=self._up(pidx)))
        fin = []
        for b in seg.fin:
            boff = np.asarray(b.boff, dtype=np.int64)
            _require(np.all(boff >= 0)
                     and np.all(boff + b.P * b.H <= ws[b.ccls]),
                     "finalize bucket slice past the window end")
            _require(np.all((b.w >= 0) & (b.w <= b.c)),
                     "finalize width outside the class width")
            _require(b.H >= b.c and np.all((b.cnt >= 0) & (b.cnt <= b.P)),
                     "finalize bucket shorter than its width, or its lane "
                     "count outside [0, P]")
            _require(np.all((b.cols0 >= 0) & (b.cols0 <= n))
                     and np.all((b.rows >= 0) & (b.rows <= n)),
                     "finalize column/row id outside [0, n]")
            fin.append(_FinTables(cnt=np.asarray(b.cnt, dtype=np.int64),
                                  boff=boff, w=self._up(b.w),
                                  cols0=self._up(b.cols0),
                                  rows=self._up(b.rows)))
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
            cap = max(1, int(getattr(self.plan, "fin_chol_elems",
                                     32 * 2**20)) // (c * c))
            groups, cur, cur_p = [], [], 0
            for k in mine:
                b = seg.fin[k]
                if cur and cur_p + b.P > cap:
                    groups.append(cur)
                    cur, cur_p = [], 0
                cur.append(k)
                cur_p += b.P
            if cur:
                groups.append(cur)
            fin_groups.append(groups)
        return _SegTables(rlo=rlo, upd=upd, fin=fin, gsc=gsc_t,
                          fin_groups=fin_groups, fin_fused=fin_fused)

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
                _require(m[0].min() >= 0 and m[0].max() < npan[ci] * c,
                         f"bmap class {ci} position outside the xb pool")
                _require(m[1].min() >= 0 and m[1].max() < n,
                         f"bmap class {ci} column outside [0, n)")
            self._bmap.append((self._up(m[0], torch.int64),
                               self._up(m[1], torch.int64)))
        _require(plan.slotw is not None
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
                _require(np.all(srlo[ci] >= 0)
                         and np.all(srlo[ci] + sw[ci] <= npan[ci]),
                         f"class {ci} slot window past the xb/Linv pool "
                         f"end")
                _require(np.all((strue[ci] >= 0) & (strue[ci] <= sw[ci])),
                         f"class {ci} true slots outside the slot window")
            _require(len(seg.soff) == len(seg.fin),
                     "one slot offset table per finalize bucket")
            soff = []
            for b, so in zip(seg.fin, seg.soff):
                so = np.asarray(so, dtype=np.int64)
                _require(np.all(so >= 0)
                         and np.all(srlo[b.ccls] + so + b.P
                                    <= npan[b.ccls]),
                         "Linv pool slice past the pool end")
                soff.append(so)
            supd = []
            for b in seg.supd:
                b8 = np.asarray(b.brow, dtype=np.int64) // 8
                _require(b8.min(initial=0) >= 0
                         and b8.max(initial=0) + b.Q // 8
                         <= self._nrows[b.kcls] // 8,
                         "solve B-operand gather past the pool end")
                _require(b.xrow.min(initial=0) >= 0
                         and b.xrow.max(initial=0) < npan[b.kcls],
                         "solve source slot outside the xb pool")
                _require(b.colq.min(initial=0) >= 0
                         and b.colq.max(initial=0) <= b.c,
                         "solve column index outside the target width")
                _require(b.dst.min(initial=0) >= 0
                         and b.dst.max(initial=0) <= sw[b.ccls],
                         "solve target slot outside the slot window")
                supd.append(_SolveUpdTables(
                    b8=self._up(b8), xrow=self._up(b.xrow),
                    colq=self._up(b.colq), dst=self._up(b.dst)))
            self._ssegs.append(_SolveTables(
                srlo=srlo, strue=strue, soff=soff, supd=supd,
                has_cls=[any(b.ccls == ci for b in seg.fin)
                         for ci in range(self.ncls)]))

    # ------------------------------------------------------------- pools
    def _rows_view(self, pool, ci, start, rows):
        """(rows, c) row window [start, start+rows) of a packed pool, as a
        view (bounds checked at construction)."""
        return pool.view(-1, self.classes[ci])[start:start + rows]

    def _init_pools(self, a_data):
        """Scatter A values into zeroed per-class packed pools."""
        if a_data.shape != (self._nnz_a,):
            raise ValueError(f"expected {self._nnz_a} A values, got "
                             f"{tuple(a_data.shape)}")
        pools = []
        for ci, c in enumerate(self.classes):
            r = self._nrows[ci]
            pos, sel = self._a_map[ci]
            flat = torch.zeros(r * c, dtype=self.dtype, device=self.device)
            flat.index_add_(0, pos, a_data[sel])
            pools.append(flat.view(r // 8, 8 * c))
        return pools

    # ----------------------------------------------------------- updates
    def _update_block(self, pools, b, ut: _UpdTables, t):
        """One update bucket at step t: C = (A @ B_raw^T) @ S^T, (GP, Mc, c),
        with S the one-hot column-alignment selector from ``colq``."""
        pool8 = pools[b.kcls]
        A = pool8[ut.a8[t][:, None] + self._ar(b.Mc // 8)].reshape(
            -1, b.Mc, b.K)
        Braw = pool8[ut.b8[t][:, None] + self._ar(b.Q // 8)].reshape(
            -1, b.Q, b.K)
        Chat = torch.bmm(A, Braw.transpose(1, 2))
        S = (self._ar(b.c)[None, :, None]
             == ut.colq[t][:, None, :]).to(self.dtype)
        return torch.bmm(Chat, S.transpose(1, 2))

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
            zero = torch.zeros((1, c), dtype=self.dtype, device=self.device)
            call = torch.cat([zero] + cbuf[ci])
            parts = [zero] + [call[gi[t]].sum(dim=1) for gi in ent["gidx"]]
            wins[ci].sub_(torch.cat(parts)[ent["pidx"][t]])

    def _apply_updates(self, pools, wins, seg, tabs, t):
        """Batched update GEMMs row-added into per-class delta windows
        (one trailing dummy row takes the padding); one subtraction lands
        each on its window."""
        if tabs.gsc is not None:
            return self._apply_updates_gather(pools, wins, seg, tabs, t)
        deltas = [torch.zeros((seg.wslice[ci] + 1, c), dtype=self.dtype,
                              device=self.device)
                  for ci, c in enumerate(self.classes)]
        for b, ut in zip(seg.upd, tabs.upd):
            C = self._update_block(pools, b, ut, t)
            deltas[b.ccls].index_add_(0, ut.dst[t].reshape(-1),
                                      C.reshape(-1, b.c))
        for ci in range(self.ncls):
            wins[ci].sub_(deltas[ci][:seg.wslice[ci]])

    # ---------------------------------------------------------- finalize
    def _finalize(self, wins, seg, tabs, t):
        """Shared blocked Cholesky per width class + per-bucket TRSM-as-
        GEMM on contiguous window slices.  Every bucket reads the
        pre-finalize window and adds a lane-masked diff to one per-class
        delta; padded lanes contribute zero.

        A fused class instead runs one ``finalize_fused`` per bucket and
        adds its diff in place, bucket after bucket, as the JAX fused
        branch does: real lanes never overlap across buckets and padded
        lanes' diffs are zero, so this equals the delta accumulation."""
        for ci, c in enumerate(self.classes):
            for k in tabs.fin_fused[ci]:
                b, ft = seg.fin[k], tabs.fin[k]
                off = int(ft.boff[t])
                blk = wins[ci][off:off + b.P * b.H].view(b.P, b.H, c)
                blk += finalize_fused(blk, ft.w[t], int(ft.cnt[t]))
            groups = tabs.fin_groups[ci]
            if not groups:
                continue
            win = wins[ci]
            delta = torch.zeros_like(win)
            blks, ws = {}, {}
            for grp in groups:
                for k in grp:
                    b, ft = seg.fin[k], tabs.fin[k]
                    off = int(ft.boff[t])
                    blks[k] = win[off:off + b.P * b.H].view(b.P, b.H, c)
                    ws[k] = ft.w[t]
            Ls, Linvs = {}, {}
            for grp in groups:
                D = dense.masked_spd(
                    torch.cat([blks[k][:, :c, :] for k in grp]),
                    torch.cat([ws[k] for k in grp]), c, self.dtype)
                Lg, Lig = chol_inverse(D)
                off = 0
                for k in grp:
                    Pk = seg.fin[k].P
                    Ls[k] = Lg[off:off + Pk]
                    Linvs[k] = Lig[off:off + Pk]
                    off += Pk
            for k in sorted(blks):
                b, ft = seg.fin[k], tabs.fin[k]
                # Linv^T rides in the (otherwise zero) strict upper
                # triangle of the diag block: the solves read it back
                # (_inv_blk)
                diff = dense.finalize_diff(blks[k], ws[k], int(ft.cnt[t]),
                                           Ls[k], Linvs[k])
                off = int(ft.boff[t])
                delta[off:off + b.P * b.H] += diff.view(-1, c)
            win += delta

    # ------------------------------------------------------------ factor
    def _step(self, pools, seg, tabs, t):
        wins = [self._rows_view(pools[ci], ci, int(tabs.rlo[ci, t]),
                                seg.wslice[ci])
                for ci in range(self.ncls)]
        self._apply_updates(pools, wins, seg, tabs, t)
        self._finalize(wins, seg, tabs, t)

    def factorize(self, a_data):
        """Numeric supernodal Cholesky: A values (permuted lower CSC data)
        -> per-class packed panel pools (a tuple of device tensors)."""
        a = torch.as_tensor(a_data).to(device=self.device, dtype=self.dtype)
        pools = self._init_pools(a)
        for seg, tabs in zip(self.plan.segments, self._segs):
            for t in range(seg.nsteps):
                self._step(pools, seg, tabs, t)
        return tuple(pools)

    # ------------------------------------------------------------ solves
    def _panel_blk(self, pools, b, ft, rlo, t):
        start = int(rlo[b.ccls, t]) + int(ft.boff[t])
        return self._rows_view(pools[b.ccls], b.ccls, start,
                               b.P * b.H).view(b.P, b.H, b.c)

    def _inv_blk(self, blk, w, c):
        """The diag block's triangular inverse from the pool: strict lower
        = transpose of the Linv^T stored in the strict upper triangle by
        ``_finalize``, diagonal = 1/l_ii (zero on padded columns)."""
        ar = self._ar(c)
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

    def _vec(self, b):
        b = torch.as_tensor(b).to(device=self.device, dtype=self.dtype)
        if b.shape != (self.plan.n,):
            raise ValueError(f"expected a vector of {self.plan.n}, got "
                             f"{tuple(b.shape)}")
        return b

    def _solve_lower_impl(self, pools, b_vec):
        """Forward substitution over the wavefront schedule."""
        n = self.plan.n
        zero1 = torch.zeros(1, dtype=self.dtype, device=self.device)
        x = torch.zeros(n + 1, dtype=self.dtype, device=self.device)
        bc = torch.cat([b_vec, zero1])
        for seg, tabs in zip(self.plan.segments, self._segs):
            for t in range(seg.nsteps):
                dx = torch.zeros_like(x)
                dbc = torch.zeros_like(x)
                for b, ft in zip(seg.fin, tabs.fin):
                    blk = self._panel_blk(pools, b, ft, tabs.rlo, t)
                    w = ft.w[t]
                    Linv = self._inv_blk(blk, w, b.c)
                    arc = self._ar(b.c)
                    cidx = torch.clamp(ft.cols0[t][:, None] + arc, max=n)
                    colv = arc[None, :] < w[:, None]
                    bvec = bc[cidx] * colv
                    xs_ = torch.bmm(Linv, bvec[:, :, None])[:, :, 0] * colv
                    # same-level panels' columns are disjoint and start
                    # at zero, so add == set
                    dx.index_add_(0, torch.where(colv, cidx, n).reshape(-1),
                                  xs_.masked_fill(~colv, 0).reshape(-1))
                    y = torch.bmm(blk, xs_[:, :, None])[:, :, 0]
                    below = self._ar(b.H)[None, :] >= w[:, None]
                    ridx = torch.where(below, ft.rows[t], n)
                    dbc.index_add_(0, ridx.reshape(-1),
                                   (-(y * below)).reshape(-1))
                x = x + dx
                x[n] = 0
                bc = bc + dbc
                bc[n] = 0
        return x[:n]

    def _solve_upper_impl(self, pools, b_vec):
        """Backward substitution: the schedule in reverse."""
        n = self.plan.n
        zero1 = torch.zeros(1, dtype=self.dtype, device=self.device)
        x = torch.zeros(n + 1, dtype=self.dtype, device=self.device)
        bp = torch.cat([b_vec, zero1])
        for seg, tabs in zip(reversed(self.plan.segments),
                             reversed(self._segs)):
            for t in reversed(range(seg.nsteps)):
                dx = torch.zeros_like(x)
                for b, ft in zip(seg.fin, tabs.fin):
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
                    rhs = (bp[cidx] - tt) * colv
                    xs_ = torch.bmm(Linv.transpose(1, 2),
                                    rhs[:, :, None])[:, :, 0] * colv
                    dx.index_add_(0, torch.where(colv, cidx, n).reshape(-1),
                                  xs_.masked_fill(~colv, 0).reshape(-1))
                x = x + dx
                x[n] = 0
        return x[:n]

    def _linv_pools(self, pools):
        """Slot-ordered per-class pools of diag-block inverses:
        linv[ci][slot] = Linv of the panel at that slot, so that every
        step of the fast solve takes one contiguous slice and one batched
        product per class."""
        linv = [torch.zeros((self._npanels[ci], c, c), dtype=self.dtype,
                            device=self.device)
                for ci, c in enumerate(self.classes)]
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

    def solve_prep(self, pools):
        """The slot-ordered Linv pools of the fast forward solve, built
        once per factorization.  Cached on the pools' identity and their
        version counters, so new pools or pools changed in place rebuild
        it."""
        key = tuple(p._version for p in pools)
        hit = self._solve_prep_cache
        if (hit is not None and len(hit[0]) == len(pools)
                and all(p is q for p, q in zip(hit[0], pools))
                and hit[1] == key):
            return hit[2]
        linv = self._linv_pools(pools)
        self._solve_prep_cache = (tuple(pools), key, linv)
        return linv

    def _solve_lower_fast_impl(self, pools, b_vec, linv):
        """Forward substitution with the right-hand side in panel-column
        layout (xb pools: one c-wide row per panel slot).  Per level step
        each update pair lands one column-aligned row
        y = L_overlap x_src on its target slot, and each class then takes
        one slice of the Linv pool and one batched product for its
        diagonal solves.  Counterpart of the JAX executor's
        ``_solve_lower_fast_impl`` without the dense top and the
        aligned-operand pool (both refused at construction)."""
        n = self.plan.n
        xb = []
        for ci, c in enumerate(self.classes):
            pos, sel = self._bmap[ci]
            flat = torch.zeros(self._npanels[ci] * c, dtype=self.dtype,
                               device=self.device)
            flat[pos] = b_vec[sel]
            xb.append(flat.view(-1, c))
        for seg, st in zip(self.plan.segments, self._ssegs):
            for t in range(seg.nsteps):
                # every operand is gathered (copied) before any slot
                # window of this step is written
                deltas = [None] * self.ncls
                for b, su in zip(seg.supd, st.supd):
                    xsrc = xb[b.kcls][su.xrow[t]]                # (P, K)
                    Braw = pools[b.kcls][
                        su.b8[t][:, None] + self._ar(b.Q // 8)
                    ].reshape(-1, b.Q, b.K)
                    y = torch.bmm(Braw, xsrc[:, :, None])        # (P, Q, 1)
                    S = (self._ar(b.c)[None, :, None]
                         == su.colq[t][:, None, :]).to(self.dtype)
                    if deltas[b.ccls] is None:
                        deltas[b.ccls] = torch.zeros(
                            (seg.sslice[b.ccls] + 1, b.c), dtype=self.dtype,
                            device=self.device)
                    deltas[b.ccls].index_add_(0, su.dst[t],
                                              torch.bmm(S, y)[:, :, 0])
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
        out = torch.zeros(n, dtype=self.dtype, device=self.device)
        for ci in range(self.ncls):
            pos, sel = self._bmap[ci]
            out[sel] = xb[ci].reshape(-1)[pos]
        return out

    def solve_lower(self, pools, b):
        """x = L^{-1} b (forward substitution, level-parallel): the
        pair-granular fast solve when the plan carries its tables (after
        ``solve_prep``), else the leveled one."""
        b = self._vec(b)
        if self._has_fast_solve:
            return self._solve_lower_fast_impl(pools, b,
                                               self.solve_prep(pools))
        return self._solve_lower_impl(pools, b)

    def solve_upper(self, pools, b):
        """x = L^{-T} b (backward substitution)."""
        return self._solve_upper_impl(pools, self._vec(b))

    def solve_spd(self, pools, b):
        """x = (L L^T)^{-1} b, through the leveled forward solve (as the
        JAX executor's ``solve_spd``)."""
        return self._solve_upper_impl(
            pools, self._solve_lower_impl(pools, self._vec(b)))

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
