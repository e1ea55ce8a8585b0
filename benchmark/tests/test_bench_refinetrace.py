"""The refinement's readers (``refine_ms``, ``residual_roofline``, through
``benchmark/refinetrace.py``) on synthetic traces and a stub system: the
hand-computed value, and None where nothing can be read."""
import types

import numpy as np
import pytest

from benchmark import devtrace, harness, peaks, refinetrace

READ = {name: harness.load_metric(name).read
        for name in ("refine_ms", "residual_roofline")}
H100 = "NVIDIA H100 80GB HBM3"
KERNEL = ("void at::native::indexFuncLargeIndex<double, int, unsigned "
          "int, 1, 1, -2, true>(double*)")
#: the solves' own scatter-add, on the factor's float32 and int64 indices
SOLVE_SCATTER = ("void at::native::indexFuncLargeIndex<float, long, "
                 "unsigned int, 1, 1, -2, true>(float*)")
#: a lower-half pattern of 4 columns, 6 entries, 4 on the diagonal
INDPTR, INDICES = [0, 2, 3, 5, 6], [0, 2, 1, 2, 3, 3]


def _solve_ops(t0, residual_us=(4, 6)):
    """A solve span's operations from t0 (us): b's upload, the first
    solve's copy into its input, replay and clone, x's cast to float64;
    per sweep the residual (b's clone, two gathers and the product, 1 us
    each, then the scatter-add, ``residual_us``, back to back), r's copy
    into the input, the replay, the clone, x's update; x's copy back."""
    ops, t = [], t0

    def op(name, d, gap=1):
        nonlocal t
        ops.append((name, t, t + d))
        t += d + gap
    op("Memcpy HtoD (Pageable -> Device)", 5)
    op("copy", 1)
    op("solve_node", 50)
    op(SOLVE_SCATTER, 2)
    op("Memcpy DtoD (Device -> Device)", 1)
    op("cast", 1)
    for us in residual_us:
        op("Memcpy DtoD (Device -> Device)", 1, gap=0)
        op("indexSelectLargeIndex", 1, gap=0)
        op("indexSelectLargeIndex", 1, gap=0)
        op("mul", 1, gap=0)
        op(KERNEL, us)
        op("copy", 1)
        op("solve_node", 50)
        op(SOLVE_SCATTER, 2)
        op("Memcpy DtoD (Device -> Device)", 1)
        op("add", 1)
    op("Memcpy DtoH (Device -> Pageable)", 5)
    return ops


def _run(ops, spans, sweeps=2, steps=2, kind=H100):
    steps_iv = [(min(s for iv in spans.values() for s, _ in iv),
                 max(e for iv in spans.values() for _, e in iv))]
    tr = devtrace.Trace(sorted(ops, key=lambda o: o[1]),
                        dict(spans, step=steps_iv), [])
    ap = types.SimpleNamespace(n=4, nnz=6, indptr=np.array(INDPTR),
                               indices=np.array(INDICES))
    solver = types.SimpleNamespace(ap=ap)
    if sweeps is not None:
        solver.refine_sweeps = sweeps
    cell = types.SimpleNamespace(config={"solver": {"refine_steps": steps}})
    return types.SimpleNamespace(trace=tr, cell=cell, device_kind=kind,
                                 system=types.SimpleNamespace(solver=solver))


def _two_solves(**kw):
    a, b = _solve_ops(0), _solve_ops(1000, (8, 10))
    return _run(a + b, {"solve": [(0, 400), (1000, 1400)]}, **kw)


def test_refine_ms_by_hand():
    """Each sweep: the residual 4 + its scatter-add, then copy 1, replay
    50 and its scatter-add 2, clone 1 and update 1; the gaps of 1 between
    them are left out of the busy union."""
    busy = [sum(4 + us + 1 + 50 + 2 + 1 + 1 for us in usx)
            for usx in ((4, 6), (8, 10))]
    assert READ["refine_ms"](_two_solves()) == pytest.approx(
        sum(busy) / 2 / 1e3)


def test_residual_roofline_by_hand():
    nbytes = (2 * 6 - 4) * 20 + 2 * 4 * 8
    t = (8 + 10 + 12 + 14) / 4 / 1e6
    want = 100 * nbytes / peaks.PEAKS[H100]["hbm_byte_per_s"] / t
    assert READ["residual_roofline"](_two_solves()) == pytest.approx(want)


def test_residual_work_by_hand():
    """Three products of 20 bytes from a lower half of 2 entries, 1 on
    the diagonal, and b and r of 8 bytes an entry."""
    work = harness.load_metric("residual_roofline").work
    assert work(3, 2, 1) == 3 * 20 + 6 * 8


def test_each_residual_is_its_scatter_add_and_the_operations_before():
    ((ops, at),) = refinetrace.solves(_run(_solve_ops(0), {"solve":
                                                           [(0, 400)]}))
    for i in at:
        names = [op[0] for op in ops[i:i + refinetrace.RESIDUAL_OPS]]
        assert names[0].startswith("Memcpy DtoD") and names[-1] == KERNEL


@pytest.mark.parametrize("sweeps", [None, 1, 0])
def test_none_where_the_sweep_counter_disagrees(sweeps):
    """A program without the counter (an older commit) or one that ran
    another count of sweeps gives nothing."""
    run = _two_solves(sweeps=sweeps)
    assert all(read(run) is None for read in READ.values())


def test_none_without_refinement_in_the_configuration():
    run = _two_solves(sweeps=0, steps=0)
    assert all(read(run) is None for read in READ.values())


def test_none_without_the_scatter_add():
    """A program that computes its residual elsewhere (the host) leaves no
    scatter-add in the trace."""
    ops = [op for op in _solve_ops(0) if op[0] != KERNEL]
    run = _run(ops, {"solve": [(0, 400)]})
    assert all(read(run) is None for read in READ.values())


def test_none_where_a_scatter_add_opens_the_span():
    """A scatter-add with too few operations before it is no residual of
    the refined solve."""
    ops = _solve_ops(0)[6:]
    run = _run(ops, {"solve": [(0, 400)]})
    assert refinetrace.solves(run) == []


def test_a_span_with_a_sweep_missing_is_left_out():
    a, b = _solve_ops(0, (4,)), _solve_ops(1000, (8, 10))
    run = _run(a + b, {"solve": [(0, 400), (1000, 1400)]})
    assert READ["refine_ms"](run) == pytest.approx(
        (2 * (4 + 1 + 50 + 2 + 1 + 1) + 8 + 10) / 1e3)


def test_none_on_a_trace_without_device_operations():
    run = _run([], {"solve": [(0, 400)]})
    assert all(read(run) is None for read in READ.values())


def test_none_on_a_card_without_peaks():
    assert READ["residual_roofline"](_two_solves(kind="cpu")) is None
    assert READ["refine_ms"](_two_solves(kind="cpu")) is not None


def test_the_solves_own_scatter_adds_are_no_residual():
    """The leveled solves' ``index_add_`` on float32 values and int64
    indices is not counted: only the float64 scatter-add on int32
    indices opens a residual."""
    ((ops, at),) = refinetrace.solves(_run(_solve_ops(0), {"solve":
                                                           [(0, 400)]}))
    scatters = [i for i, op in enumerate(ops) if op[0] == SOLVE_SCATTER]
    assert len(scatters) == 3 and len(at) == 2
