"""The port's spans (``ops/trace.py``) and the scope maps of its captured
programs.

* With no profiler running, ``span`` is one shared no-op context.
* Under a CPU ``torch.profiler``, a ``CholeskySolver`` factorize and solve
  show every span of the solver's host path and of the executor, once per
  call, nested under ``solver.factorize`` and ``solver.solve``.
* The scope map's bookkeeping, driven by a stubbed node counter (the CPU
  captures no graph): contiguous ranges without overlap that cover every
  node, each under its innermost span.
* On the card (``card``: skips without CUDA): the scope ranges of a
  captured ``factorize`` cover its nodes, every K1 operation of its replay
  maps to ``fin.k1`` and every cuBLAS GEMM or GEMV to a scope that
  multiplies (``upd.product``, ``upd.align``, ``fin.diff``); a program
  of one node (no edge) captures with its scope map.  Run there without this directory's conftest, which imports
  JAX: ``PYTHONPATH=. python3 -m pytest --noconftest -p no:cacheprovider
  tests/test_torch_trace.py -m card``.
"""
import contextlib

import numpy as np
import pytest
import torch

from parsy_bench_tpu_torch.config import SolverConfig
from parsy_bench_tpu_torch.core.generate import laplace_3d
from parsy_bench_tpu_torch.models import CholeskySolver
from parsy_bench_tpu_torch.ops import supernodal, trace
from parsy_bench_tpu_torch.ops.trace import span

#: the spans of one call, each under the call's outermost span
FACTORIZE_SPANS = ("solver.permute_values", "executor.load",
                   "program.{}.factorize", "executor.clone",
                   "solver.spd_check")
SOLVE_SPANS = ("solver.permute_rhs", "executor.load",
               "program.{}.solve_spd", "executor.clone", "solver.fetch_x",
               "solver.unpermute_x")


def _cpu_profile(fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof.events()


def _spans(evs, names):
    """{name: [parent name]} of the events named in ``names``."""
    out = {}
    for e in evs:
        if e.name in names:
            p = e.cpu_parent
            out.setdefault(e.name, []).append(p.name if p else None)
    return out


def test_span_without_a_profiler_is_the_shared_noop():
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = span("solver.factorize"), span("executor.load")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        with b:
            pass
    # nothing was recorded: a profile taken after holds none of them
    evs = _cpu_profile(lambda: None)
    assert not [e for e in evs if e.name in ("solver.factorize",
                                             "executor.load")]


def test_span_under_a_profiler_records():
    def fn():
        with span("outer"):
            with span("inner"):
                pass
    got = _spans(_cpu_profile(fn), {"outer", "inner"})
    assert got == {"outer": [None], "inner": ["outer"]}


@pytest.mark.parametrize("tier", ["supernodal", "simplicial"])
@pytest.mark.parametrize("first", [True, False], ids=["capture", "replay"])
def test_solver_spans_under_a_cpu_profile(tier, first):
    """Every span of a factorize and a solve, once each, directly under
    the call's span; the program's span names its capture on the first
    call and its replay after."""
    a = laplace_3d(8)
    s = CholeskySolver(a, SolverConfig(tier=tier), device="cpu")
    b = np.random.default_rng(0).standard_normal(a.n)
    if not first:
        s.factorize(a).solve(b)
    box = {}
    evs = _cpu_profile(lambda: box.update(x=s.factorize(a).solve(b)))
    how = "capture" if first else "replay"
    fac = [n.format(how) for n in FACTORIZE_SPANS]
    sol = [n.format(how) for n in SOLVE_SPANS]
    got = _spans(evs, set(fac + sol + ["solver.factorize", "solver.solve",
                                       "solver.refine"]))
    assert got.pop("solver.factorize") == [None]
    assert got.pop("solver.solve") == [None]
    for n in ("executor.load", "executor.clone"):
        assert sorted(got.pop(n)) == ["solver.factorize", "solver.solve"]
    for n in fac:
        if n in got:
            assert got.pop(n) == ["solver.factorize"], n
    for n in sol:
        if n in got:
            assert got.pop(n) == ["solver.solve"], n
    assert got == {}
    assert s.solve_residual(b, box["x"]) < 1e-4


def test_solve_refine_span():
    """With refinement b is permuted and x fetched once, under
    ``solver.solve``; each sweep's residual is a ``solver.residual`` under
    ``solver.refine``."""
    a = laplace_3d(6)
    s = CholeskySolver(a, SolverConfig(refine_steps=2), device="cpu")
    b = np.ones(a.n)
    s.factorize(a)
    evs = _cpu_profile(lambda: s.solve(b))
    got = _spans(evs, {"solver.refine", "solver.residual",
                       "solver.permute_rhs", "solver.unpermute_x",
                       "solver.fetch_x"})
    assert got["solver.refine"] == ["solver.solve"]
    assert got["solver.residual"] == ["solver.refine"] * 2
    for n in ("solver.permute_rhs", "solver.fetch_x", "solver.unpermute_x"):
        assert got[n] == ["solver.solve"]


class _Graph:
    """Stands in for a graph being captured: ``op`` adds a node."""

    def __init__(self):
        self.n = 0

    def op(self, k=1):
        self.n += k


def _covers(scopes, nodes):
    at = 0
    for name, lo, hi in scopes:
        assert lo == at and hi > lo, scopes
        at = hi
    assert at == nodes


def test_scope_map_innermost_contiguous_cover():
    g = _Graph()
    smap = trace.ScopeMap(lambda: g.n)
    with trace.recording(smap):
        g.op()                              # 0: unscoped
        with span("upd.operands"):
            g.op(2)                         # 1, 2
            with span("fin.k1"):
                g.op()                      # 3: the innermost
            g.op()                          # 4
            with span("fin.spd"):
                pass                        # no node: no range
        with span("upd.operands"):
            g.op()                          # 5: joins the range before
        with span("slv.lower"):
            with span("slv.upper"):
                g.op(3)                     # 6, 7, 8
        g.op()                              # 9
    g.op(2)                                 # 10, 11: after the last span
    scopes = smap.close(g.n)
    assert scopes == [("unscoped", 0, 1), ("upd.operands", 1, 3),
                      ("fin.k1", 3, 4), ("upd.operands", 4, 6),
                      ("slv.upper", 6, 9), ("unscoped", 9, 12)]
    _covers(scopes, g.n)
    assert trace._recording is None
    assert span("x") is trace._NOOP


def test_scope_map_resolves_positions_at_close():
    """On the card a boundary reads the graph's last node, and ``close``
    turns each into its place in the chain once the graph is whole."""
    nodes = []

    def op(k=1):
        nodes.extend([f"node{len(nodes) + i}" for i in range(k)])
    smap = trace.ScopeMap(lambda: nodes[-1] if nodes else None)
    with trace.recording(smap):
        with span("init"):
            op(2)
        op()
        with span("fin.k1"):
            op(3)
    order = {None: 0, **{h: i + 1 for i, h in enumerate(nodes)}}
    assert smap.close(len(nodes), order.__getitem__) == [
        ("init", 0, 2), ("unscoped", 2, 3), ("fin.k1", 3, 6)]


def test_scope_map_every_node_in_a_scope():
    g = _Graph()
    smap = trace.ScopeMap(lambda: g.n)
    with trace.recording(smap):
        for name in supernodal.SCOPES + supernodal.SOLVE_SCOPES:
            with span(name):
                g.op(3)
    scopes = smap.close(g.n)
    _covers(scopes, g.n)
    assert [s[0] for s in scopes] == list(supernodal.SCOPES
                                          + supernodal.SOLVE_SCOPES)


def test_scope_map_records_under_a_profiler_too():
    g = _Graph()
    smap = trace.ScopeMap(lambda: g.n)

    def fn():
        with trace.recording(smap):
            with span("fin.k1"):
                g.op()
    evs = _cpu_profile(fn)
    assert [e.name for e in evs if e.name == "fin.k1"] == ["fin.k1"]
    assert smap.close(g.n) == [("fin.k1", 0, 1)]


def test_one_map_records_at_a_time():
    smap = trace.ScopeMap(lambda: 0)
    with trace.recording(smap):
        with pytest.raises(RuntimeError):
            with trace.recording(trace.ScopeMap(lambda: 0)):
                pass
    assert trace._recording is None


def test_a_failed_capture_leaves_no_map_recording():
    with pytest.raises(ValueError):
        with trace.recording(trace.ScopeMap(lambda: 0)):
            raise ValueError("capture failed")
    assert trace._recording is None


class _Launches:
    """Counts the operations dispatched inside it that would launch work
    on the card (not views, not bare allocations): the CPU's stand-in for
    a captured graph's nodes."""

    def __init__(self):
        self.ops = []

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        outer = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if not func.is_view and func.overloadpacket.__name__ not in (
                        "empty", "empty_strided"):
                    outer.ops.append(func.overloadpacket.__name__)
                return out
        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


@pytest.mark.parametrize("update_delta", ["gather", "scatter"])
def test_every_operation_of_the_programs_lies_in_a_scope(update_delta):
    """The closures of the captured ``factorize`` and ``solve_spd``
    programs, run under a scope map counting their operations: the step
    loop's all lie in ``SCOPES``, the solve's in ``SOLVE_SCOPES`` but for
    the last, x's copy into the static output."""
    a = laplace_3d(8)
    s = CholeskySolver(a, SolverConfig(ordering="nd", tier="supernodal",
                                       update_delta=update_delta),
                       device="cpu")
    ex = s.executor
    ex._load_a(s.ap.data)
    ex._b_in.copy_(torch.ones(a.n))
    solve = lambda: ex._x_out.copy_(ex._solve_upper_impl(  # noqa: E731
        ex._pools, ex._solve_lower_impl(ex._pools, ex._b_in)))
    for fn, scopes, tail in ((ex._chain(0, len(ex._segs), init=True),
                              supernodal.SCOPES, 0),
                             (solve, supernodal.SOLVE_SCOPES, 1)):
        with _Launches() as ops:
            smap = trace.ScopeMap(lambda: len(ops.ops))
            with trace.recording(smap):
                fn()
        got = smap.close(len(ops.ops))
        _covers(got, len(ops.ops))
        inside = sum(hi - lo for n, lo, hi in got if n in scopes)
        assert inside == len(ops.ops) - tail > 0
        if tail:
            assert got[-1] == (trace.UNSCOPED, len(ops.ops) - 1,
                               len(ops.ops))
            assert ops.ops[-1] == "copy_"


def _node_names(prog):
    out = []
    for name, lo, hi in prog.scopes:
        assert lo == len(out)
        out.extend([name] * (hi - lo))
    return out


@pytest.mark.card
def test_card_replay_maps_kernels_to_their_scopes():
    """The factorize program's nodes all lie in the step's scopes, its
    replay's device operations are its nodes one to one, K1's map to
    ``fin.k1`` and cuBLAS's GEMMs and GEMVs to the scopes that multiply
    (the update products, the alignment and the finalize tail's
    product)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from parsy_bench_tpu_torch.scripts import attribution
    dev = torch.device("cuda")
    a = laplace_3d(12)
    s = CholeskySolver(a, SolverConfig(ordering="nd", tier="supernodal"),
                       device=dev)
    b = np.ones(a.n)
    s.factorize(a).solve(b)
    ex = s.executor
    for name in ("factorize", "solve_spd"):
        _covers(ex.programs[name].scopes, ex.programs[name].nodes)
    assert {n for n, _, _ in ex.programs["solve_spd"].scopes} <= set(
        supernodal.SOLVE_SCOPES) | {trace.UNSCOPED}
    prog = ex.programs["factorize"]
    names = _node_names(prog)

    def device_ops(evs):
        return sorted((e for e, _ in attribution._work(evs, dev)),
                      key=lambda e: e.time_range.start)
    evs, _, _ = attribution.profile(
        prog.run, dev, accept=lambda evs: len(device_ops(evs)) == prog.nodes)
    ops = device_ops(evs)
    assert len(ops) == prog.nodes
    unscoped = [(i, e.name[:60]) for i, (e, sc) in enumerate(zip(ops, names))
                if sc not in supernodal.SCOPES]
    assert not unscoped, unscoped[:8]
    k1 = [sc for e, sc in zip(ops, names)
          if any(k in e.name for k in attribution.K1_NAMES)]
    gemm = [sc for e, sc in zip(ops, names)
            if "gemm" in e.name or "gemv" in e.name]
    assert len(k1) == ex.chol_calls_per_factorize > 0
    assert set(k1) == {"fin.k1"}
    assert gemm and set(gemm) <= {"upd.product", "upd.align", "fin.diff"}


@pytest.mark.card
def test_card_one_node_program_has_its_scope_map():
    """A program of one device operation (a segment's restore in
    ``SegmentTimer`` when one class holds its rows) is one chain without
    an edge: it captures, replays, and its node lies in its span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from parsy_bench_tpu_torch.ops import graphs
    dev = torch.device("cuda")
    x = torch.zeros(8, device=dev)

    def fn():
        with span("init"):
            x.add_(1)
    prog = graphs.Program("one", fn, dev)
    prog.run()
    prog.run()
    assert prog.nodes == 1
    assert prog.scopes == [("init", 0, 1)]
