"""The per-layer metrics' arithmetic: K1's FLOPs and bytes against a hand
count, the roofline share, and the trace's busy, idle and span sums."""
import types

import numpy as np
import pytest
import torch

from benchmark import devtrace, harness, peaks
from benchmark.tests.common import SEED, tiny_cell

K1 = harness.load_metric("k1_roofline")


def _plan(buckets, nsteps):
    seg = types.SimpleNamespace(nsteps=nsteps, fin=[
        types.SimpleNamespace(cnt=np.array(cnt), w=np.array(w))
        for cnt, w in buckets])
    return types.SimpleNamespace(segments=[seg])


def test_k1_work_by_hand():
    # step 0: lanes of width 3 and 5 (a third lane padded); step 1: one
    # lane of width 2
    plan = _plan([([2, 1], [[3, 5, 0], [2, 0, 0]])], 2)
    flops, nbytes = K1.work(plan, 4)
    assert flops == pytest.approx(2 * (27 + 125 + 8) / 3)
    assert nbytes == 3 * (6 + 15 + 3) * 4


def test_k1_work_counts_each_panel_once():
    """On a real plan the finalize lanes are the supernodes' panels, each
    finalized once at its width."""
    from parsy_bench_tpu_torch.config import SolverConfig
    from parsy_bench_tpu_torch.core.csc import CSC
    from parsy_bench_tpu_torch.models import CholeskySolver
    cell = tiny_cell("grid3d_7pt_110k.refactor", side=10)
    inp = cell.steps.make_inputs(cell, SEED)
    p = inp.pattern
    s = CholeskySolver(CSC(p.n, p.indptr, p.indices, inp.values[0]),
                       SolverConfig(**cell.config["solver"]), device="cpu")
    w = np.diff(s.plan.layout.part.sptr).astype(np.float64)
    flops, nbytes = K1.work(s.plan, 4)
    assert w.sum() == p.n
    assert flops == pytest.approx(np.sum(2 * w ** 3 / 3))
    assert nbytes == pytest.approx(np.sum(3 * w * (w + 1) / 2) * 4)


def _trace(ops, spans):
    return devtrace.Trace(ops, spans, [("aten::copy_", 40, 55)])


def test_k1_roofline_share():
    plan = _plan([([1], [[128]])], 1)
    flops, nbytes = K1.work(plan, 4)
    pk = peaks.PEAKS["NVIDIA H100 80GB HBM3"]
    least = max(flops / pk["float32_flop_per_s"],
                nbytes / pk["hbm_byte_per_s"])
    tr = _trace([("chol_inverse_blocked_kernel<float>", 10, 30),
                 ("other", 30, 40)],
                {"step": [(0, 100)], "factorize": [(0, 100)]})
    run = types.SimpleNamespace(
        trace=tr, device_kind="NVIDIA H100 80GB HBM3",
        cell=types.SimpleNamespace(config={"solver": {"dtype": "float32"}}),
        system=types.SimpleNamespace(solver=types.SimpleNamespace(plan=plan)))
    assert K1.read(run) == pytest.approx(100 * least / 20e-6)
    run.device_kind = "cpu"
    assert K1.read(run) is None


def test_busy_idle_and_spans():
    ops = [("a", 10, 20), ("b", 15, 30), ("c", 60, 70), ("d", 90, 95),
           ("late", 150, 160)]
    tr = _trace(ops, {"step": [(0, 50), (50, 100)],
                      "factorize": [(0, 50)], "solve": [(50, 100)]})
    assert tr.window_s() == pytest.approx(100e-6)
    assert tr.busy_s() == pytest.approx(35e-6)
    assert devtrace.idle_share(tr, tr.window_s()) == pytest.approx(65.0)
    assert tr.idle_gaps() == [(0, 10), (30, 60), (70, 90), (95, 100)]
    assert devtrace.per_span(tr, "factorize") == [
        (pytest.approx(20e-6), 2)]
    assert devtrace.per_span(tr, "solve") == [(pytest.approx(15e-6), 2)]
    gaps = dict(devtrace.top_gaps(tr))
    assert gaps["factorize: aten::copy_"] == pytest.approx(30e-6)
    assert gaps["gaps under 20 us"] == pytest.approx(15e-6)
    assert gaps["solve"] == pytest.approx(20e-6)
    assert devtrace.top_ops(tr)[0] == ["b", pytest.approx(15e-6)]
    empty = _trace([], {"step": [(0, 10)], "factorize": [(0, 10)]})
    assert devtrace.per_span(empty, "factorize") == []
    assert devtrace.idle_share(empty, 10e-6) is None


def test_idle_share_is_taken_over_the_untraced_wall():
    """The profiler's own host time (a buffer flush here) lengthens the
    traced window but not the untraced steps the share is taken over."""
    ops = [("a", 0, 40), ("b", 70, 100)]
    spans = {"step": [(0, 100)], "solve": [(0, 100)]}
    tr = devtrace.Trace(ops, spans, [("aten::copy_", 40, 70),
                                     ("Buffer Flush", 45, 65)])
    assert tr.host_at(55) == "solve: Buffer Flush"
    assert dict(devtrace.top_gaps(tr)) == {
        "solve: Buffer Flush": pytest.approx(30e-6)}
    assert devtrace.idle_share(tr, 100e-6) == pytest.approx(30.0)
    assert devtrace.idle_share(tr, 80e-6) == pytest.approx(12.5)
    run = types.SimpleNamespace(trace=tr, untraced_s=80e-6)
    for name in ("idle_share.refactor", "idle_share.resolve"):
        assert harness.load_metric(name).read(run) == pytest.approx(12.5)


def test_profile_reads_the_spans_and_host_operations():
    """A CPU profile: the harness's spans nest as opened, the host's
    operations are kept to label gaps, and no device operation is read."""
    x = torch.zeros(16)

    def steps():
        for _ in range(3):
            with devtrace.span("step"):
                with devtrace.span("solve"):
                    x.add_(1)
    tr = devtrace.profile(steps, torch.device("cpu"))
    assert tr.ops == [] and len(tr.spans["step"]) == 3
    assert len(tr.spans["solve"]) == 3
    for (s, e), (s2, e2) in zip(tr.spans["step"], tr.spans["solve"]):
        assert 0 <= s <= s2 <= e2 <= e
    assert 0 < tr.window_s() < 10
    adds = [h for h in tr.host if h[0] == "aten::add_"]
    assert len(adds) == 3 and tr.host_at(adds[0][1]) == "solve: aten::add_"
