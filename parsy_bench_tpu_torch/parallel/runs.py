"""Rank programs of the multi-device tier: what each rank of a
``comm.launch`` runs for the tests, for ``chip_smoke.py`` and for the
scaling driver (``scripts/scaling.py``).

Each ``run_*`` builds one executor in the calling rank and factorizes
with the kernels' launch counts and the group's ``psum`` counts at 0
before the call; where the job asks, through the one profiler
(``scripts/attribution.profile``: an unprofiled call, then the primed
profile, retried by all ranks together), with the counts reset before
each call, so that they are one factorize's.  That factorize also
records the (P, c) of every batch ``chol_inverse`` (K1 on a card) gets;
afterwards K1 is held against its plain version at each of those shapes
(``_check_k1``).  Then the rank runs what the job asks (factor values,
solves, the grouped factorize, timed repeats) and returns a dict of host
values: numbers for every rank, the arrays from rank 0 only, and from
every rank a digest of its arrays' bytes (equal digests: equal arrays on
every rank).  ``run_jobs`` runs several in one launch, so that the ranks
start once.

This module imports no JAX: under the ``spawn`` start method each rank
imports the module that holds its function (``comm.py``).
"""
from __future__ import annotations

import contextlib
import hashlib
import sys
import time

import torch
import torch.distributed as dist

from parsy_bench_tpu_torch.ops import dense, kernels, supernodal
from parsy_bench_tpu_torch.scripts import attribution


def _jax_free() -> bool:
    """True when this process holds no module of jax or of the JAX
    package."""
    return not any(
        (m in ("jax", "jaxlib", "parsy_bench_tpu")
         or m.startswith(("jax.", "jaxlib.", "parsy_bench_tpu.")))
        and sys.modules[m] is not None for m in list(sys.modules))


def _timed(device, fn):
    """(host seconds, result) of one call, synchronized on both sides."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0, out


def _profiled(group, fn):
    """(busy ms of the last call of ``fn``, the profile's host ms,
    profiles taken, the last call's result): ``attribution.profile``, with
    its unprofiled first call, its primer and its retries, which the ranks
    take together (``fn`` meets the other ranks in ``psum``s).  Busy is
    the summed time of the call's operations (``attribution._work``: on
    the card their device time, without the primers and the device-side
    marks of ``record_function`` scopes; on the CPU the host time of the
    top-level operations); None where there were none: not measured."""
    out = []

    def agree(ok):
        t = torch.tensor([int(ok)], device=group.device)
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
        return bool(t.item())

    def call():
        out[:] = [fn()]

    evs, wall_ms, tries = attribution.profile(
        call, group.device, agree=agree if group.size > 1 else None)
    ms = sum(m for _, m in attribution._work(evs, group.device))
    return (ms if ms > 0 else None), wall_ms, tries, out[0]


@contextlib.contextmanager
def _chol_shapes():
    """The set of (P, c) of the batches ``supernodal.chol_inverse`` gets
    while open (the executors call it through that module)."""
    shapes = set()
    inner = supernodal.chol_inverse

    def recording(D):
        shapes.add(tuple(D.shape[:2]))
        return inner(D)

    supernodal.chol_inverse = recording
    try:
        yield shapes
    finally:
        supernodal.chol_inverse = inner


def _check_k1(device, dtype, shapes, seed):
    """``chol_inverse`` (K1 on a card) against its plain version
    ``dense.cholesky_inverse`` on the same random masked-SPD blocks at
    each (P, c) of ``shapes``, at the bars of chip_smoke.py's K1 check:
    max |dL| <= tol * c and max |dLinv| <= tol, tol 1e-5 in f32 and 1e-10
    in f64.  Raises on a miss; returns [P, c, |dL|, |dLinv|] per shape."""
    gen = torch.Generator(device=device).manual_seed(seed)
    tol = 1e-5 if dtype == torch.float32 else 1e-10
    out = []
    for P, c in sorted(shapes):
        A = torch.randn((P, c, c), generator=gen, device=device,
                        dtype=dtype)
        D0 = torch.bmm(A, A.transpose(1, 2)) + c * torch.eye(
            c, device=device, dtype=dtype)
        w = torch.randint(0, c + 1, (P,), generator=gen, device=device,
                          dtype=torch.int32)
        w[::7] = 0
        w[1::7] = c
        D = dense.masked_spd(D0, w, c, dtype)
        L, Linv = supernodal.chol_inverse(D)
        Lp, Linvp = dense.cholesky_inverse(D)
        err_l = float((L - Lp).abs().max())
        err_i = float((Linv - Linvp).abs().max())
        if not (err_l <= tol * c and err_i <= tol):
            raise AssertionError(
                f"K1 disagrees with its plain version at the rank's batch "
                f"shape ({P}, {c}): |dL| {err_l:.3e} (bar {tol * c:.1e}), "
                f"|dLinv| {err_i:.3e} (bar {tol:.0e})")
        out.append([P, c, err_l, err_i])
    return out


class _Record(dict):
    """A rank's result: ``put`` keeps an array's digest on every rank and
    the array itself on rank 0."""

    def __init__(self, group, **kw):
        super().__init__(rank=group.rank, size=group.size,
                         device=str(group.device), backend=group.backend,
                         jax_free=_jax_free(), **kw)
        self.rank0 = group.rank == 0
        self["digest"] = {}

    def put(self, key, t):
        a = t.detach().cpu().numpy()
        self["digest"][key] = hashlib.sha1(a.tobytes()).hexdigest()
        if self.rank0:
            self[key] = a


def _first_factorize(group, rec, ex, a_data, profile):
    """The rank's first factorize, with every count at 0 before it: its
    counts, its chol batch shapes and its host seconds into ``rec``; with
    ``profile`` it goes through ``_profiled``, which calls it unprofiled
    and then profiled (again on a retry), so the counts are reset before
    each call and are the profiled call's, and its busy ms go into
    ``rec`` too (on the CPU host ms, as ``host_busy_ms``).  Then K1
    checked at those shapes."""
    dev = group.device
    secs = []
    with _chol_shapes() as shapes:
        def once():
            kernels.reset_launch_counts()
            group.reset_counts()
            shapes.clear()
            t, pools = _timed(dev, lambda: ex.factorize(a_data))
            secs.append(t)
            return pools

        if profile:
            busy, wall_ms, tries, pools = _profiled(group, once)
            # on the CPU the profile reads host time
            rec["device_busy_ms" if dev.type == "cuda"
                else "host_busy_ms"] = busy
            rec.update(profiled_wall_ms=wall_ms, profiles_taken=tries)
        else:
            pools = once()
    rec.update(first_factorize_s=secs[0],
               k1_launches=kernels.cholesky_inverse_cuda.launches,
               psum_calls=group.calls, psum_bytes=group.nbytes,
               k1_checks=_check_k1(dev, ex.dtype, shapes, group.rank))
    return pools


def _repeats(group, rec, ex, a_data, pools, solves, reps, time_group=None):
    """``reps`` timed factorizes (``factorize_segmented(a_data,
    time_group)`` where ``time_group`` is given) and solves (sorted host
    seconds)."""
    dev = group.device

    def fact():
        if time_group is None:
            return ex.factorize(a_data)
        return ex.factorize_segmented(a_data, time_group)

    if reps:
        rec["factorize_s"] = sorted(_timed(dev, fact)[0]
                                    for _ in range(reps))
        rec["timed"] = ("factorize" if time_group is None
                        else f"factorize_segmented({time_group})")
        rec["solve_s"] = {
            name: sorted(_timed(dev, lambda: getattr(ex, name)(pools, b))[0]
                         for _ in range(reps))
            for name, b in solves.items()}


def run_dist(group, plan, a_data, dtype="float32", lpat=None, solves=None,
             segmented=None, reps=0, profile=False, time_group=None) -> dict:
    """``DistExecutor`` in this rank: factorize; with ``lpat`` the factor
    values; each of ``solves`` (name -> b: ``solve_lower``,
    ``solve_upper``, ``solve_spd``); with ``segmented`` the grouped
    factorize against ``factorize`` (max |difference|, pool scale); the
    timed repeats of ``factorize``, or of ``factorize_segmented(a_data,
    time_group)`` where ``time_group`` is given (the scaling driver's)."""
    from parsy_bench_tpu_torch.parallel.dist import DistExecutor
    solves = solves or {}
    init_s, ex = _timed(group.device, lambda: DistExecutor(
        plan, group, dtype, group.device))
    rec = _Record(group, executor="DistExecutor", init_s=init_s,
                  chol_calls_per_factorize=ex.chol_calls_per_factorize,
                  pool_bytes=sum(int(r) * c for r, c in zip(
                      plan.nrows, plan.classes)) * ex.dtype.itemsize)
    pools = _first_factorize(group, rec, ex, a_data, profile)
    rec["pool_devices"] = sorted({str(p.device) for p in pools})
    if lpat is not None:
        rec.put("values", ex.factor_values(pools, lpat))
    if segmented:
        got = ex.factorize_segmented(a_data, segmented)
        rec["segmented_max_diff"] = max(float((p - q).abs().max())
                                        for p, q in zip(got, pools))
        rec["pool_scale"] = max(float(p.abs().max()) for p in pools)
    for name, b in solves.items():
        rec.put(name, getattr(ex, name)(pools, b))
    _repeats(group, rec, ex, a_data, pools, solves, reps, time_group)
    return rec


def run_sharded_supernodal(group, plan, a_data, dtype="float32",
                           solves=None, reps=0, profile=False) -> dict:
    """``ShardedSupernodalExecutor`` in this rank: factorize, the factor
    values and each of ``solves`` (``solve_lower``, ``solve_spd``)."""
    from parsy_bench_tpu_torch.parallel.sharded import (
        ShardedSupernodalExecutor)
    solves = solves or {}
    init_s, ex = _timed(group.device, lambda: ShardedSupernodalExecutor(
        plan, group, dtype, group.device))
    rec = _Record(group, executor="ShardedSupernodalExecutor",
                  init_s=init_s,
                  chol_calls_per_factorize=ex.chol_calls_per_factorize)
    pools = _first_factorize(group, rec, ex, a_data, profile)
    rec["pool_devices"] = sorted({str(p.device) for p in pools})
    rec.put("values", ex.factor_values(pools))
    for name, b in solves.items():
        rec.put(name, getattr(ex, name)(pools, b))
    _repeats(group, rec, ex, a_data, pools, solves, reps)
    return rec


def run_sharded_simplicial(group, plan, a_data, dtype="float32", reps=0,
                           profile=False) -> dict:
    """``ShardedSimplicialExecutor`` in this rank: factorize and its L
    values."""
    from parsy_bench_tpu_torch.parallel.sharded import (
        ShardedSimplicialExecutor)
    init_s, ex = _timed(group.device, lambda: ShardedSimplicialExecutor(
        plan, group, dtype, group.device))
    rec = _Record(group, executor="ShardedSimplicialExecutor",
                  init_s=init_s,
                  levels=sum(sg["nsteps"] for sg in ex._segs))
    lx = _first_factorize(group, rec, ex, a_data, profile)
    rec["pool_devices"] = [str(lx.device)]
    rec.put("values", lx)
    _repeats(group, rec, ex, a_data, None, {}, reps)
    return rec


RUNS = {"dist": run_dist, "sharded_supernodal": run_sharded_supernodal,
        "sharded_simplicial": run_sharded_simplicial}


def run_jobs(group, jobs) -> list:
    """Each job ``(name, kwargs)`` of ``RUNS`` in turn, in this rank, with
    its host seconds as ``job_s``; the device's cached blocks are released
    between jobs."""
    out = []
    for name, kw in jobs:
        job_s, rec = _timed(group.device, lambda: RUNS[name](group, **kw))
        rec["job_s"] = job_s
        out.append(rec)
        if group.device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def fail_on(group, rank) -> None:
    """Rank ``rank`` raises; the others wait in a ``psum`` for it (the
    launcher's failure test)."""
    if group.rank == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    group.psum(torch.ones(4, device=group.device))
