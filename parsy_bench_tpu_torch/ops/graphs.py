"""Captured programs: the port's counterpart of the JAX executor's compiled
programs (``jax.jit``).

A ``Program`` wraps a closure that reads and writes only static tensors:
inputs, outputs and scratch allocated once, outside any capture.

* On a CUDA device the first ``run`` runs the closure once on the capture
  stream as its warm-up (the kernels are built, cuBLAS handles and
  workspaces created, each kernel's shared-memory attribute set), captures
  it with ``torch.cuda.graph`` and instantiates the graph.  The first
  run's results are the warm-up's; every later ``run`` replays the graph.
  A capture or replay that fails raises: nothing falls back to running the
  closure on the card.
* On the CPU ``run`` calls the closure: that is the caller asking for the
  CPU.

The programs of one executor share one memory pool
(``torch.cuda.graph_pool_handle``).  That is safe because every tensor a
closure allocates dies inside it (it writes its results into static
tensors allocated outside the pool) and the replays are serialized on one
stream, so no program reads memory that another's temporaries reuse.

Each program records:

* ``launches``: the kernel launches each wrapper of ``ops/kernels.py``
  issued while the closure was captured, by wrapper name; under replay
  these are the launches per replay (the wrappers' counters advance only
  at warm-up and capture).  On the CPU the same is counted over the first
  run (plain versions count nothing unless a caller stubs them);
* ``capture_s``: seconds of warm-up, capture and instantiation (None on
  the CPU);
* ``nodes``: the graph's node count, read with ``cuGraphGetNodes`` of
  ``libcuda`` (None on the CPU);
* ``scopes``: the span each node was captured in (``trace.ScopeMap``;
  None on the CPU, and where the graph is not one chain).

Each run opens the span ``program.capture.<name>`` (the first) or
``program.replay.<name>`` (``trace.span``).

``ProgramHost`` is what the executors share: their programs by name,
their index tables on the device and the record of which tensors their
static inputs hold.
"""
from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from parsy_bench_tpu_torch.ops import kernels, trace

_capture_streams: dict = {}
_libcuda = None


def _capture_stream(device: torch.device):
    """One side stream per device for warm-ups and captures, so that the
    cuBLAS workspace the warm-up creates is the one the capture uses."""
    if device not in _capture_streams:
        _capture_streams[device] = torch.cuda.Stream(device)
    return _capture_streams[device]


def _cuda():
    """``libcuda``, with the signatures of the calls made here
    (``cudaGraph_t`` is its ``CUgraph``, ``cudaStream_t`` its
    ``CUstream``; a ``CUgraphNode`` is a pointer)."""
    global _libcuda
    if _libcuda is None:
        lib = ctypes.CDLL("libcuda.so.1")
        p, vp, size = ctypes.POINTER, ctypes.c_void_p, ctypes.c_size_t
        lib.cuGraphGetNodes.argtypes = [vp, vp, p(size)]
        lib.cuGraphGetRootNodes.argtypes = [vp, vp, p(size)]
        lib.cuGraphGetEdges_v2.argtypes = [vp, vp, vp, vp, p(size)]
        lib.cuStreamGetCaptureInfo_v2.argtypes = [
            vp, p(ctypes.c_int), p(ctypes.c_uint64), p(vp), p(p(vp)),
            p(size)]
        for fn in (lib.cuGraphGetNodes, lib.cuGraphGetRootNodes,
                   lib.cuGraphGetEdges_v2, lib.cuStreamGetCaptureInfo_v2):
            fn.restype = ctypes.c_int
        _libcuda = lib
    return _libcuda


def _check(err, call):
    if err != 0:
        raise RuntimeError(f"{call} failed: CUresult {err}")


def _node_count(graph) -> int:
    """Nodes of a captured, kept ``torch.cuda.CUDAGraph``."""
    n = ctypes.c_size_t(0)
    _check(_cuda().cuGraphGetNodes(graph.raw_cuda_graph(), None,
                                   ctypes.byref(n)), "cuGraphGetNodes")
    return int(n.value)


#: a capture position where the stream's work had forked: no chain
_FORK = "fork"


def _capture_position(stream):
    """() -> the node the next operation captured on ``stream`` will
    depend on: the graph's last node (None before the first; ``_FORK``
    where the capture depends on several).  One driver call, whatever
    the graph's size."""
    status, deps, ndeps = (ctypes.c_int(0), ctypes.POINTER(ctypes.c_void_p)(),
                           ctypes.c_size_t(0))
    call = _cuda().cuStreamGetCaptureInfo_v2
    args = (ctypes.c_void_p(stream.cuda_stream), ctypes.byref(status),
            ctypes.byref(ctypes.c_uint64()), ctypes.byref(ctypes.c_void_p()),
            ctypes.byref(deps), ctypes.byref(ndeps))

    def position():
        _check(call(*args), "cuStreamGetCaptureInfo_v2")
        # CU_STREAM_CAPTURE_STATUS_ACTIVE
        if status.value != 1:
            raise RuntimeError(f"stream not capturing: status "
                               f"{status.value}")
        n = ndeps.value
        return deps[0] if n == 1 else (None if n == 0 else _FORK)
    return position


def _chain_order(graph, nodes: int):
    """{node: its place in the chain, from 1} of a captured, kept graph,
    with None at 0; None where the graph is not one chain (one root, each
    node followed by one at most)."""
    lib, h = _cuda(), graph.raw_cuda_graph()
    n = ctypes.c_size_t(0)
    _check(lib.cuGraphGetRootNodes(h, None, ctypes.byref(n)),
           "cuGraphGetRootNodes")
    if n.value != 1:
        return None
    root = (ctypes.c_void_p * 1)()
    _check(lib.cuGraphGetRootNodes(h, root, ctypes.byref(n)),
           "cuGraphGetRootNodes")
    _check(lib.cuGraphGetEdges_v2(h, None, None, None, ctypes.byref(n)),
           "cuGraphGetEdges_v2")
    k = n.value
    frm, to = (ctypes.c_void_p * k)(), (ctypes.c_void_p * k)()
    # CUgraphEdgeData is 8 bytes
    data = (ctypes.c_uint8 * (8 * k))()
    # a one-node graph has no edge, and the driver refuses empty arrays
    if k:
        _check(lib.cuGraphGetEdges_v2(h, frm, to, data, ctypes.byref(n)),
               "cuGraphGetEdges_v2")
    succ = dict(zip(frm, to))
    if len(succ) != k or k != nodes - 1:
        return None
    order, node = {None: 0}, root[0]
    while node is not None and node not in order:
        order[node] = len(order)
        node = succ.get(node)
    return order if len(order) == nodes + 1 else None


def graph_pool(device: torch.device):
    """The memory pool handle the programs of one executor share (None on
    the CPU)."""
    return torch.cuda.graph_pool_handle() if device.type == "cuda" else None


class Program:
    """One closure over static tensors, captured on first use on a CUDA
    device and replayed after (see the module docstring)."""

    def __init__(self, name: str, fn, device: torch.device, pool=None):
        self.name = name
        self.fn = fn
        self.device = device
        self.pool = pool
        self.graph = None
        self.launches: dict | None = None
        self.capture_s: float | None = None
        self.nodes: int | None = None
        #: (innermost span, first node, end node) of the graph's nodes in
        #: node order (``trace.ScopeMap``; None on the CPU and where the
        #: graph is not one chain)
        self.scopes: list | None = None
        self._capture_span = "program.capture." + name
        self._replay_span = "program.replay." + name

    def run(self) -> None:
        """Replay the program (its first run: capture it), in the span
        ``program.replay.<name>`` (``program.capture.<name>``)."""
        first = self.launches is None
        with trace.span(self._capture_span if first else self._replay_span):
            if self.device.type != "cuda":
                if first:
                    before = kernels.launch_counts()
                    self.fn()
                    self.launches = _delta(before)
                else:
                    self.fn()
                return
            with torch.cuda.device(self.device):
                if first:
                    self._capture()
                else:
                    self.graph.replay()

    def _capture(self) -> None:
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        side = _capture_stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.fn()
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = kernels.launch_counts()
        with torch.cuda.graph(graph, pool=self.pool, stream=side):
            smap = trace.ScopeMap(_capture_position(side))
            with trace.recording(smap):
                self.fn()
        launches = _delta(before)
        self.nodes = _node_count(graph)
        order = _chain_order(graph, self.nodes)
        self.scopes = None
        if order is not None:
            try:
                self.scopes = smap.close(self.nodes, order.__getitem__)
            except KeyError:    # a boundary where the capture had forked
                pass
        graph.instantiate()
        self.graph, self.launches = graph, launches
        self.capture_s = time.perf_counter() - t0


def _delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in kernels.launch_counts().items()}


class ProgramHost:
    """The programs of one executor, its index tables on the device and
    the record of what its static tensors hold.  An executor sets
    ``device``, uploads its tables with ``_up``, calls
    ``_init_programs(device)`` once, allocates its static tensors outside
    any capture, and runs its entry points as
    ``_program(name, closure).run()``."""

    #: bytes of index tables held on the device (``_up``)
    table_bytes = 0

    def _up(self, arr, dtype=torch.int32) -> torch.Tensor:
        """A host table as a tensor on the executor's device."""
        t = torch.as_tensor(np.ascontiguousarray(arr)).to(
            device=self.device, dtype=dtype)
        self.table_bytes += t.numel() * t.element_size()
        return t

    def _init_programs(self, device: torch.device) -> None:
        #: name -> (the tensors the static ones hold, their version
        #: counters then); a replay bumps no counter, so each program that
        #: writes a static tensor resets its entry
        self._held = {}
        self._graph_pool = graph_pool(device)
        #: name -> ``Program``, made at first use
        self.programs = {}

    def _program(self, name, fn) -> Program:
        """The program ``name``, made from the closure ``fn`` at first
        use."""
        prog = self.programs.get(name)
        if prog is None:
            prog = Program(name, fn, self.device, self._graph_pool)
            self.programs[name] = prog
        return prog

    def _hold(self, name, tensors) -> None:
        self._held[name] = (tuple(tensors),
                            tuple(t._version for t in tensors))

    def _holds(self, name, tensors) -> bool:
        held = self._held.get(name)
        return (held is not None and len(held[0]) == len(tensors)
                and all(p is q for p, q in zip(held[0], tensors))
                and held[1] == tuple(t._version for t in tensors))

    def _load(self, name, static, tensors) -> None:
        """Copy ``tensors`` into the static tensors of the programs unless
        they hold them already (the same tensors at the same version
        counters)."""
        tensors = tuple(torch.as_tensor(t) for t in tensors)
        if self._holds(name, tensors):
            return
        if (len(tensors) != len(static)
                or any(t.shape != s.shape for s, t in zip(static, tensors))):
            raise ValueError(
                f"expected {name} of shapes "
                f"{[tuple(s.shape) for s in static]}, got "
                f"{[tuple(t.shape) for t in tensors]}")
        for s, t in zip(static, tensors):
            s.copy_(t)
        self._hold(name, tensors)


def elapsed_s(device: torch.device, fn) -> float:
    """Seconds ``fn`` takes: between two CUDA events on the card (device
    time of the work it enqueues), on the host clock on the CPU."""
    if device.type == "cuda":
        with torch.cuda.device(device):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
        return e0.elapsed_time(e1) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0
