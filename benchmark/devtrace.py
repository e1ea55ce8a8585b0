"""The traced window: one torch.profiler profile of a few steps, read into
device operations, the benchmark's own spans and the host's operations.

``profile`` is a frozen copy of the program's
``scripts/attribution.profile`` (primer and retries; the benchmark keeps its
own so that a later change to the program cannot change the yardstick),
reading the profiler's raw events.  On
the H100 a profile can lose the first device operations of its window, so
``PRIMER_OPS`` small operations open it, and a profile that shows none of
them is taken again, up to three times in all.

Device operations are attributed to the benchmark's spans by time: every
span the harness opens (``record_function``) ends in a synchronize, so the
device work it launched ran inside it.

The profiler costs host time of its own: CUPTI's activity buffers are
requested and flushed on the host, and a CUDA graph launches more slowly
under it, while the device waits.  So ``idle_share`` takes the device's
busy time from the trace and the wall time of the same steps run just
before without the profiler; the harness logs a traced step's wall time
beside an untraced one's (``trace_cost``).
"""
from __future__ import annotations

import bisect
import dataclasses
import functools

import numpy as np
import torch
from torch.autograd import DeviceType

#: the primer: ``exp_`` of one element, ``PRIMER_OPS`` times
PRIMER_NAME = "exp_kernel"
PRIMER_OPS = 512
#: the prefix of the harness's spans (``bench.<name>``); ``bench.step``
#: wraps each traced step
PREFIX = "bench."
#: idle gaps shorter than this (microseconds), as between the operations of
#: one graph, are summed apart; longer ones are labelled by what the host
#: was doing
SHORT_GAP_US = 20.0


@dataclasses.dataclass
class Trace:
    """A traced window: times in microseconds on the profiler's clock."""
    #: (name, start, end) of every device operation in the window
    ops: list
    #: span name (without the prefix) -> [(start, end)]
    spans: dict
    #: (name, start, end) of the host operations, to label the device's
    #: idle gaps
    host: list

    @property
    def window(self):
        """(start, end) of the traced steps."""
        steps = self.spans.get("step", [])
        return (min(s for s, _ in steps), max(e for _, e in steps))

    def window_s(self) -> float:
        lo, hi = self.window
        return (hi - lo) / 1e6

    def ops_in(self, span: str) -> list:
        """The device operations that started inside a ``span``, one list
        per span."""
        starts = [op[1] for op in self.ops]
        return [self.ops[bisect.bisect_left(starts, s):
                         bisect.bisect_left(starts, e)]
                for s, e in self.spans.get(span, [])]

    def busy_s(self) -> float:
        lo, hi = self.window
        return union([(max(s, lo), min(e, hi)) for _, s, e in self.ops
                      if e > lo and s < hi]) / 1e6

    def idle_gaps(self) -> list:
        """[(start, end)] of the window's stretches with no device
        operation running."""
        lo, hi = self.window
        out, cur = [], lo
        for s, e in merged([(s, e) for _, s, e in self.ops]):
            if e <= lo or s >= hi:
                continue
            if s > cur:
                out.append((cur, s))
            cur = max(cur, e)
        if hi > cur:
            out.append((cur, hi))
        return out

    @functools.cached_property
    def _host_arrays(self):
        return (np.array([s for _, s, _ in self.host], dtype=np.float64),
                np.array([e for _, _, e in self.host], dtype=np.float64))

    def host_op_at(self, t):
        """The name of the innermost host operation running at time t, or
        None."""
        if not self.host:
            return None
        s, e = self._host_arrays
        inside = (s <= t) & (t < e)
        if not inside.any():
            return None
        return self.host[int(np.argmin(np.where(inside, e - s, np.inf)))][0]

    def host_at(self, t) -> str:
        """The innermost host operation running at time t, within the
        innermost harness span: what the host was doing."""
        span = None
        for name, ivs in self.spans.items():
            if name == "step":
                continue
            for s, e in ivs:
                if s <= t < e:
                    span = name
        label = span or "between spans"
        op = self.host_op_at(t)
        if op is not None:
            label += ": " + op
        return label


def merged(ivs):
    """Sorted, overlapping intervals merged."""
    out = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union(ivs) -> float:
    """Length of the union of intervals."""
    return sum(e - s for s, e in merged([iv for iv in ivs if iv[1] > iv[0]]))


def _is_device_op(e) -> bool:
    name = e.name()
    return (e.device_type() == DeviceType.CUDA
            and not e.is_user_annotation()
            and not name.startswith(PREFIX)
            and PRIMER_NAME not in name)


def profile(fn, device) -> Trace:
    """``fn`` (which opens the harness's spans with ``span``) under
    torch.profiler, with CUDA activity on the card; on the CPU the trace
    holds no device operation.  The profiler's raw events are read
    (``kineto_results``): building its Python event objects
    (``prof.events()``) takes about 60 times as long, over a minute for a
    traced window of some 700,000 device operations."""
    from torch.profiler import ProfilerActivity, profile as _profiler
    acts = [ProfilerActivity.CPU]
    cuda = device.type == "cuda"
    if cuda:
        acts.append(ProfilerActivity.CUDA)
        primer = torch.zeros(1, device=device)
    for _ in range(3):
        with _profiler(activities=acts) as prof:
            if cuda:
                for _ in range(PRIMER_OPS):
                    primer.exp_()
                torch.cuda.synchronize(device)
            fn()
            if cuda:
                torch.cuda.synchronize(device)
        evs = prof.profiler.kineto_results.events()
        primed = not cuda or any(
            e.device_type() == DeviceType.CUDA and PRIMER_NAME in e.name()
            for e in evs)
        if primed:
            break
    if not primed:
        raise RuntimeError(f"torch.profiler lost all {PRIMER_OPS} primer "
                           f"operations in three profiles")
    # microseconds from the profile's first event (nanoseconds since the
    # epoch would lose a quarter microsecond in a float)
    base = min((e.start_ns() for e in evs), default=0)
    ops, spans, host = [], {}, []
    for e in evs:
        name = e.name()
        iv = ((e.start_ns() - base) / 1e3, (e.end_ns() - base) / 1e3)
        if _is_device_op(e):
            ops.append((name,) + iv)
        elif e.device_type() == DeviceType.CPU:
            if name.startswith(PREFIX):
                spans.setdefault(name[len(PREFIX):], []).append(iv)
            else:
                host.append((name,) + iv)
    ops.sort(key=lambda o: o[1])
    for v in spans.values():
        v.sort()
    return Trace(ops, spans, host)


def per_span(tr: Trace, name: str) -> list:
    """[(device busy seconds, device operations)] of each span ``name``;
    empty where the trace holds no device operation (a CPU run)."""
    if not tr.ops:
        return []
    return [(union([(s, e) for _, s, e in ops]) / 1e6, len(ops))
            for ops in tr.ops_in(name)]


def idle_share(tr: Trace, untraced_s: float):
    """The share, in %, of the traced steps' untraced wall time
    (``untraced_s``: the same steps run without the profiler) in which no
    device operation ran: 1 - the trace's busy seconds over it.  None where
    the trace holds no device operation (a CPU run)."""
    if not tr.ops:
        return None
    return 100.0 * (1.0 - tr.busy_s() / untraced_s)


def span(name: str):
    """A harness span, read back from the trace as ``name``."""
    return torch.profiler.record_function(PREFIX + name)


def top_ops(tr: Trace, k: int = 10) -> list:
    """[[name, seconds]] of the device operations that took most time in
    the window, summed by name."""
    lo, hi = tr.window
    tot = {}
    for name, s, e in tr.ops:
        if s >= lo and e <= hi:
            tot[name] = tot.get(name, 0.0) + (e - s) / 1e6
    return [[n, v] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]


def top_gaps(tr: Trace, k: int = 10) -> list:
    """[[what the host was doing, seconds]] of the window's idle time,
    summed by what the host was doing at each gap's middle."""
    tot = {}
    for s, e in tr.idle_gaps():
        label = (f"gaps under {SHORT_GAP_US:g} us"
                 if e - s < SHORT_GAP_US else tr.host_at((s + e) / 2))
        tot[label] = tot.get(label, 0.0) + (e - s) / 1e6
    return [[n, v] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]
