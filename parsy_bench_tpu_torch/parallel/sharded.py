"""The update-stream-sharded executors, one rank each of a ``Group``.

Counterparts of ``parsy_bench_tpu/parallel/sharded.py``, whose
``shard_map`` programs run once per device of a 1-D mesh; here each rank
process (``parallel/comm.py``) runs the same step loop op by op on its
device, and each JAX ``psum`` over the mesh axis is ``group.psum``.

* ``ShardedSupernodalExecutor``: the plan is built with
  ``num_partitions`` = G, which cost-packs every update bucket's chunks
  over G shards (splan ``_shard_of``).  Each rank runs its own shard into
  a private delta window and one ``psum`` per class and level step merges
  them; the finalize lanes are owner-strided (lane % G == rank) and their
  delta is ``psum``'d, so every rank ends a step with the same pools.  The
  step loop is the single-device executor's, through its rank-aware
  branches (``ops/supernodal.py``).
* ``ShardedSimplicialExecutor``: each level's update stream is cut into G
  equal slices; each rank applies its slice into a private accumulator
  and one ``psum`` per level merges them; the scale and divide steps run
  replicated.

The programs run op by op: a CUDA graph cannot hold a gloo collective,
and NCCL, whose collectives a graph can hold, needs one card per rank.
"""
from __future__ import annotations

import numpy as np
import torch

from parsy_bench_tpu_torch.ops.device import require, torch_dtype
from parsy_bench_tpu_torch.ops.simplicial import _pad_stack, segment_levels
from parsy_bench_tpu_torch.ops.supernodal import (SupernodalExecutor,
                                                  chol_groups)
from parsy_bench_tpu_torch.parallel.comm import group_device
from parsy_bench_tpu_torch.symbolic.plan import SimplicialPlan


def _pad_stack_sharded(flat, offsets, t0, t1, width, fill, nshards):
    """Like _pad_stack but width is rounded up to a multiple of nshards so
    each device receives an equal contiguous slice per step."""
    w = max(nshards, -(-width // nshards) * nshards)
    return _pad_stack(flat, offsets, t0, t1, w, fill)


class ShardedSupernodalExecutor:
    """Supernodal factorization and leveled solves in one rank of
    ``group``, on a plan built with ``num_partitions == group.size`` and
    scatter-mode update tables (a plan with G > 1 has no gather tables).
    Every rank returns the same (replicated) pools."""

    def __init__(self, plan, group, dtype="float32", device="cuda"):
        G = int(plan.nshards)
        if group.size != G:
            raise ValueError(f"plan built for {G} partitions, group has "
                             f"{group.size}")
        if any(seg.gsc is not None for seg in plan.segments):
            raise ValueError("plan with gather update tables: the sharded "
                             "executor needs scatter-mode tables")
        self.plan = plan
        self.group = group
        self._inner = SupernodalExecutor(plan, dtype,
                                         group_device(group, device))
        self.dtype = self._inner.dtype
        # per segment and class: the buckets batched into one chol_inverse
        # call, each bucket holding P / G lanes on a rank (the JAX
        # executor groups its per-device blocks)
        self._groups = [
            [chol_groups(plan, seg, [k for k, b in enumerate(seg.fin)
                                     if b.ccls == ci], c, G)
             for ci, c in enumerate(self._inner.classes)]
            for seg in plan.segments]

    @property
    def chol_calls_per_factorize(self) -> int:
        """``chol_inverse`` calls one ``factorize`` makes on every rank:
        one per chol group per level step."""
        return sum(seg.nsteps * sum(len(g) for g in groups)
                   for seg, groups in zip(self.plan.segments, self._groups))

    def factorize(self, a_data):
        """A values -> this rank's copy of the replicated panel pools."""
        ex = self._inner
        pools = ex.init_pools(a_data)
        for seg, tabs, groups in zip(self.plan.segments, ex._segs,
                                     self._groups):
            for t in range(seg.nsteps):
                wins = ex._windows(pools, seg, tabs, t)
                ex._apply_updates(pools, wins, seg, tabs, t, self.group)
                ex._finalize_shard(wins, seg, tabs, t, self.group, groups)
        return pools

    def solve_lower(self, pools, b):
        """x = L^{-1} b, each rank on its owner-strided lanes."""
        ex = self._inner
        return ex._solve_lower_impl(pools, ex._vec(b), self.group)

    def solve_spd(self, pools, b):
        """x = (L L^T)^{-1} b: the sharded forward and backward solves."""
        ex = self._inner
        return ex._solve_upper_impl(
            pools, ex._solve_lower_impl(pools, ex._vec(b), self.group),
            self.group)

    def factor_values(self, pools):
        return self._inner.factor_values(pools)


class ShardedSimplicialExecutor:
    """Numeric phase of a ``SimplicialPlan`` in one rank of ``group``: the
    factor values replicated, each level's update stream sharded (the
    group size plays the role of the reference's thread count)."""

    def __init__(self, plan: SimplicialPlan, group, dtype="float32",
                 device="cuda"):
        self.plan = plan
        self.group = group
        self.nshards = group.size
        self.dtype = torch_dtype(dtype)
        self.device = group_device(group, device)
        p = plan
        nnz, k, g = int(p.nnz), group.size, group.rank
        require(nnz + 1 < 2**31, f"nnz(L) {nnz} overflows int32")
        for name, arr in (("diag", p.diag), ("off_idx", p.off_idx),
                          ("upd_a", p.upd_a), ("upd_b", p.upd_b),
                          ("upd_dst", p.upd_dst), ("a_map", p.a_map)):
            require(len(arr) == 0 or (int(arr.min()) >= 0
                                      and int(arr.max()) < nnz),
                    f"{name} outside [0, {nnz})")
        ccnt = np.diff(p.col_off)
        ocnt = np.diff(p.off_off)
        ucnt = np.diff(p.upd_off)
        require(np.all((p.off_lcol >= 0)
                       & (p.off_lcol < np.repeat(ccnt, ocnt))),
                "off_lcol outside its level")

        def up(arr, dtype=torch.int32):
            return torch.as_tensor(np.ascontiguousarray(arr)).to(
                device=self.device, dtype=dtype)

        def mine(arr):
            # this rank's equal slice of the (T, U) update stream
            w = arr.shape[1] // k
            return up(arr[:, g * w:(g + 1) * w])

        self._segs = []
        for (t0, t1) in segment_levels(np.stack([ccnt, ocnt, ucnt], axis=1)):
            cw = int(ccnt[t0:t1].max(initial=0))
            ow = int(ocnt[t0:t1].max(initial=0))
            uw = int(ucnt[t0:t1].max(initial=0))
            self._segs.append(dict(
                nsteps=t1 - t0,
                # index_copy_ targets are int64 (it takes no other)
                diag=up(_pad_stack(p.diag, p.col_off, t0, t1, cw, nnz),
                        torch.int64),
                off_idx=up(_pad_stack(p.off_idx, p.off_off, t0, t1, ow, nnz),
                           torch.int64),
                off_lcol=up(_pad_stack(p.off_lcol, p.off_off, t0, t1, ow,
                                       0)),
                upd_a=mine(_pad_stack_sharded(p.upd_a, p.upd_off, t0, t1,
                                              uw, nnz, k)),
                upd_b=mine(_pad_stack_sharded(p.upd_b, p.upd_off, t0, t1,
                                              uw, nnz, k)),
                upd_dst=mine(_pad_stack_sharded(p.upd_dst, p.upd_off, t0,
                                                t1, uw, nnz, k))))
        self._a_map = up(p.a_map)

    def factorize(self, a_data) -> torch.Tensor:
        """Replicated L values (nnz,) from the sharded factorization."""
        nnz = int(self.plan.nnz)
        a = torch.as_tensor(a_data)
        if a.shape != self._a_map.shape:
            raise ValueError(f"expected {self._a_map.shape[0]} A values, "
                             f"got {tuple(a.shape)}")
        lx = torch.zeros(nnz + 1, dtype=self.dtype, device=self.device)
        lx.index_add_(0, self._a_map, a.to(device=self.device,
                                           dtype=self.dtype))
        for sg in self._segs:
            for t in range(sg["nsteps"]):
                s = torch.sqrt(lx.index_select(0, sg["diag"][t]))
                lx.index_copy_(0, sg["diag"][t], s)
                vals = (lx.index_select(0, sg["off_idx"][t])
                        / s.index_select(0, sg["off_lcol"][t]))
                lx.index_copy_(0, sg["off_idx"][t], vals)
                # this rank's slice of the update stream into a private
                # accumulator; the psum is the reference's conflict
                # resolution (P7)
                acc = torch.zeros_like(lx)
                acc.index_add_(0, sg["upd_dst"][t],
                               lx.index_select(0, sg["upd_a"][t])
                               * lx.index_select(0, sg["upd_b"][t]),
                               alpha=-1)
                lx += self.group.psum(acc)
                lx[nnz:].zero_()
        return lx[:nnz]
