"""What the attribution scripts share (``floor_r5``, ``fin_ablate``,
``solve_floor``).

* ``own_executor``: the scripts run on a ``SupernodalExecutor`` of their
  own, built on the solver's plan, so that their programs never overwrite
  the static pools, the ``_held`` record or the ``programs`` of the
  solver's executor, which later callers read.
* ``SegmentTimer``: each (segment, mode) is one captured ``Program``
  (``ops/graphs.py``) named ``<script>:<mode>[<segment>]`` that first
  restores the rows the segment's level steps write to the segment's input
  state and then runs the mode's variant of those steps.  It is timed over
  ``reps`` back-to-back runs, ``iters`` times, in turns with a
  restore-only program, whose median is subtracted and reported
  (``restore_s``).  Times are CUDA events on the card
  (``graphs.elapsed_s``, after a device sleep that lets the host enqueue
  the runs first), the host clock on the CPU.

  Why restore: JAX's ``run_reps`` (scripts/floor_r5.py:133-143,
  scripts/fin_ablate.py:135-144) and the JAX executor's
  ``profile_segments`` apply a segment again to its own output.  A finalize applied to a block
  it has already factored can hand K1 a block that is not SPD, which K1
  turns into NaN, and runs on NaN need not take the time of real ones
  (``reps_on_own_output`` reports whether the pools stay finite).  The
  port's ``profile_segments`` times its segments through this class.
* ``profile``: one call under torch.profiler, with the primer and the
  retries that keep the card's profiles whole; ``chip_smoke.py``'s
  profiles go through it too.
* ``scope_ms``: the device ms under each ``torch.profiler.record_function``
  scope in one profiled call, and the busy ms that no scope covers.
* ``device_ops``: one call's device operations, busy ms and a kernel's
  launches by name.

On the CPU the profiles read host time: the top-level operations' CPU ms
stand where the card's device operations stand.
"""
from __future__ import annotations

import time

import torch
from torch.autograd import DeviceType

from parsy_bench_tpu_torch.ops import graphs
from parsy_bench_tpu_torch.ops.supernodal import SupernodalExecutor

#: K1's kernels as torch.profiler names them (csrc/chol_inverse.cu)
K1_NAMES = ("chol_inverse_warp_kernel", "chol_inverse_blocked_kernel")
#: the count of K1's wrapper (``ops/kernels.launch_counts``)
K1_WRAPPER = "cholesky_inverse_cuda"
#: the kernel of the small operations (``torch.exp_`` of one element) that
#: open each profile on the card, and their count; the solver launches
#: none
PRIMER_NAME = "exp_kernel"
PRIMER_OPS = 512
#: device clock cycles slept per timed run before the start event: about
#: 100 µs at the H100's ~2 GHz, more than the host takes to enqueue a replay
_SLEEP_CYCLES = 200_000


def own_executor(solver, device) -> SupernodalExecutor:
    """A new executor on ``solver``'s plan and dtype, on ``device``.  The
    scripts time and attribute the unfused finalize, as the JAX scripts
    do: a solver whose executor finalizes fused buckets is refused."""
    if solver.executor.fused_calls_per_factorize:
        raise ValueError("the attribution scripts time the unfused "
                         "finalize: the solver's executor finalizes fused "
                         "buckets (fused_finalize=True)")
    return SupernodalExecutor(solver.plan, solver.config.dtype, device)


def a_values(ex, solver):
    """The solver's permuted A values on the executor's device."""
    return torch.as_tensor(solver.ap.data).to(device=ex.device,
                                              dtype=ex.dtype)


def k1_calls(ex, i) -> int:
    """K1 launches of segment i's level steps: one per ``chol_groups``
    batch per step."""
    return ex.plan.segments[i].nsteps * sum(
        len(g) for g in ex._segs[i].fin_groups)


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
    """The restore-and-time protocol of the module docstring on the static
    pools of ``ex``: ``begin(i)`` saves segment i's input rows (the pools
    must then hold segment i's input), ``program`` makes a mode's program
    and ``time`` times a segment's programs.  A run of the program of the
    segment's real steps then leaves the next segment's input."""

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


def reps_on_own_output(solver, device="cuda", reps=20) -> dict:
    """The pools after each segment's program ran ``reps`` times back to
    back from the segment's input state, each run on the previous run's
    output, as the JAX ``profile_segments`` runs it (on an executor of
    its own): the segments after whose runs some pool entry is not
    finite."""
    ex = own_executor(solver, device)
    ex._load_a(a_values(ex, solver))
    ex._program("init", ex._chain(0, 0, init=True)).run()
    state = [p.clone() for p in ex._pools]

    def restore():
        for p, s in zip(ex._pools, state):
            p.copy_(s)
    bad = []
    for lo, hi in ex.group_bounds(1):
        prog = ex._segments_program(lo, hi)
        restore()
        prog.run()
        restore()
        for _ in range(reps):
            prog.run()
        if not all(bool(torch.isfinite(p).all()) for p in ex._pools):
            bad.append(lo)
        restore()
        prog.run()
        for s, p in zip(state, ex._pools):
            s.copy_(p)
    return dict(reps=reps, segments=len(ex.plan.segments),
                nonfinite_segments=bad, finite=not bad)


# ------------------------------------------------------------ profiles
def profile(fn, device, accept=None, agree=None):
    """(events, host ms of the synchronized call, profiles taken) of one
    call of ``fn`` under torch.profiler (CUDA activity on the card only),
    after one unprofiled call.

    On the H100 a profile loses the first device operations of its
    window: two or three in a new process, and many more late in a long
    one (``chip_smoke.py`` phase 19, with 4 primer operations: the primer,
    the first program of a pass of 34 and its K1 launch).  So on the card
    ``PRIMER_OPS`` small operations open the window, and a profile that
    shows none of them (so may have lost some of ``fn``'s), or whose
    events ``accept`` refuses, is taken again, up to three times in all.
    Where the last shows no primer it raises; where ``accept`` refuses it,
    it is returned.  Processes whose ``fn`` meets in collectives must call
    it as often as each other: ``agree`` turns this process's verdict on a
    profile into the group's (all keep it only where all would)."""
    from torch.profiler import ProfilerActivity, profile as _profiler
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        primer = torch.zeros(1, device=device)
    fn()
    _sync(device)
    for tries in range(1, 4):
        with _profiler(activities=acts) as prof:
            if device.type == "cuda":
                for _ in range(PRIMER_OPS):
                    primer.exp_()
                _sync(device)
            t0 = time.perf_counter()
            fn()
            _sync(device)
            wall_ms = (time.perf_counter() - t0) * 1e3
        evs = prof.events()
        primed = device.type != "cuda" or any(
            PRIMER_NAME in e.name for e in evs
            if e.device_type == DeviceType.CUDA)
        ok = primed and (accept is None or accept(evs))
        if agree is not None:
            ok = agree(ok)
        if ok:
            break
    if not primed:
        raise AssertionError(f"torch.profiler lost all {PRIMER_OPS} primer "
                             f"operations in three profiles")
    return evs, wall_ms, tries


def _work(evs, device, scopes=()):
    """[(event, ms)] of the operations that do the work: on the card the
    device operations (kernels, copies, fills; not the device-side marks of
    ``record_function`` scopes), on the CPU the top-level CPU operations
    (none of their ancestors is an operation) with their CPU ms."""
    if device.type == "cuda":
        return [(e, e.device_time_total / 1e3) for e in evs
                if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and e.name not in scopes and PRIMER_NAME not in e.name]
    out = []
    for e in evs:
        if e.device_type != DeviceType.CPU or e.name in scopes:
            continue
        p = e.cpu_parent
        while p is not None and p.name in scopes:
            p = p.cpu_parent
        if p is None:
            out.append((e, e.cpu_time_total / 1e3))
    return out


def _scope_of(e, scopes):
    """The innermost scope around the CPU event ``e``, or None."""
    while e is not None:
        if e.name in scopes:
            return e.name
        e = e.cpu_parent
    return None


def _nested(evs, scopes) -> int:
    """The scope events opened inside another scope: a kernel under two
    scopes would count in both on the card."""
    return sum(1 for e in evs if e.device_type == DeviceType.CPU
               and e.name in scopes and _scope_of(e.cpu_parent, scopes))


def _kernels(e):
    """The device operations the profiler links to the CPU event ``e`` and
    to every event under it (what its ``device_time_total`` sums)."""
    yield from e.kernels
    for ch in e.cpu_children:
        yield from _kernels(ch)


def scope_ms(fn, scopes, device, unlinked=None, top=8) -> dict:
    """One profiled call of ``fn`` (after one unprofiled call): ``scopes``,
    the ms of the work operations (``_work``) under each scope; ``busy``,
    the ms of all of them; ``other``, the ms no scope covers, with its
    ``top`` operation names (``other_top``: name, operations, uncovered
    ms); ``ops``, their count; ``nested``, the scopes opened inside
    another (``_nested``).

    On the card a scope holds the device operations the profiler links to
    it, the sum its ``device_time_total`` gives, and ``unlinked`` maps a
    scope to the names of kernels that the profiler links to no CPU
    operation (the port's own kernels, launched through ``ctypes``): their
    device time is that scope's.  On the CPU a scope holds the top-level
    operations under it."""
    evs, wall_ms, _ = profile(fn, device)
    work = _work(evs, device, scopes)
    per = dict.fromkeys(scopes, 0.0)
    total, count, covered = {}, {}, {}
    for e, ms in work:
        total[e.name] = total.get(e.name, 0.0) + ms
        count[e.name] = count.get(e.name, 0) + 1
    if device.type == "cuda":
        for e in evs:
            if e.device_type == DeviceType.CPU and e.name in scopes:
                for k in _kernels(e):
                    per[e.name] += k.duration / 1e3
                    covered[k.name] = covered.get(k.name, 0.0) + (
                        k.duration / 1e3)
        for s, names in (unlinked or {}).items():
            for name, ms in total.items():
                if any(n in name for n in names):
                    per[s] += ms - covered.get(name, 0.0)
                    covered[name] = ms
    else:
        for e, ms in work:
            s = _scope_of(e, scopes)
            if s is not None:
                per[s] += ms
                covered[e.name] = covered.get(e.name, 0.0) + ms
    busy = sum(total.values())
    rest = sorted(([name[:90], count[name], ms - covered.get(name, 0.0)]
                   for name, ms in total.items()), key=lambda r: -r[2])
    return dict(scopes=per, busy=busy, other=busy - sum(per.values()),
                other_top=[r for r in rest[:top] if r[2] > 0],
                ops=len(work), nested=_nested(evs, scopes), wall_ms=wall_ms)


def device_ops(fn, device, kernel=(), expect=None) -> dict:
    """One call of ``fn`` under ``profile``: its work operations (``ops``,
    ``_work``) and their summed ms (``busy_ms``); with ``kernel`` (names)
    the launches (``k_n``) and ms (``k_ms``) of the operations whose name
    holds one of them.  A profile that shows other than ``expect``
    launches is taken again, up to three times in all (``tries``)."""
    def mine(evs):
        return [ms for e, ms in _work(evs, device)
                if any(k in e.name for k in kernel)]
    evs, _, tries = profile(fn, device, None if expect is None else
                            lambda evs: len(mine(evs)) == expect)
    work = _work(evs, device)
    out = dict(ops=len(work), busy_ms=sum(ms for _, ms in work),
               tries=tries)
    if kernel:
        out.update(k_n=len(mine(evs)), k_ms=sum(mine(evs)))
    return out
