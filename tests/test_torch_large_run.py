"""The port's reference-scale drivers
(``parsy_bench_tpu_torch/scripts/{large_run,scale_test}.py``) on the CPU
against the JAX package, at ``laplace_3d(8)`` ND (n = 512) in the scatter
update mode:

* b = L*1 from the pools' masked row sums (``large_run.pool_row_sums``,
  the path the run takes at n >= ``REFERENCE_N``) equals the port's
  ``factor_csc() @ 1`` (1e-5 of max|b| in f32, 1e-12 in f64) and the JAX
  package's (1e-4 of max|b|); its counts cover the supernodes' lower
  trapezoids exactly;
* the port's ``solve_spd`` of A*1 equals the JAX executor's (1e-4);
* ``run`` through both branches (host b and the factor residual; the
  pools' b and the SPD gate, with ``REFERENCE_N`` patched): exactly the
  JAX script's keys then the port's, both gates < 1e-3, times > 0, K1
  once per plan call per factorize (a counted stand-in); a failed gate
  writes the file and exits with the JAX script's message;
* the JAX scripts' keys, read with ``ast``; ``scale_test``'s knobs give
  the JAX script's ``SolverConfig``; without CUDA each module exits
  non-zero without a line.

A's values are perturbed from a numpy seed (diagonal raised, off-diagonal
shrunk: still SPD).  One JAX compile per (dtype, program).
"""
import ast
import dataclasses
import functools
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import torch

import parsy_bench_tpu.models as jax_models
from parsy_bench_tpu.config import SolverConfig as JaxConfig
from parsy_bench_tpu.core import generate as jax_generate
from parsy_bench_tpu.models import CholeskySolver as JaxSolver
from parsy_bench_tpu_torch import CholeskySolver, SolverConfig
from parsy_bench_tpu_torch.core import generate
from parsy_bench_tpu_torch.ops import dense, kernels, supernodal
from parsy_bench_tpu_torch.scripts import large_run, scale_test
from test_torch_native import reload_native_libs

reload_native_libs()
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_GRID = 8
_SMALL = 6


@functools.lru_cache(maxsize=None)
def _solvers(dtype):
    """(port solver, JAX solver, A values from the seed), scatter mode,
    both factored on the CPU (``factorize_segmented(group=8)``)."""
    kw = dict(ordering="nd", dtype=dtype, tier="supernodal",
              update_delta="scatter")
    port = CholeskySolver(generate.laplace_3d(_GRID), SolverConfig(**kw),
                          device="cpu")
    ref = JaxSolver(jax_generate.laplace_3d(_GRID), JaxConfig(**kw))
    ap = port.ap
    np.testing.assert_array_equal(ap.data, ref.ap.data)
    rng = np.random.default_rng(14)
    col = np.repeat(np.arange(ap.n), np.diff(ap.indptr))
    diag = ap.indices == col
    vals = ap.data.astype(np.float64).copy()
    vals[diag] += rng.uniform(0.0, 1.0, int(diag.sum()))
    vals[~diag] *= rng.uniform(0.5, 1.0, int((~diag).sum()))
    vals = vals.astype(dtype)
    port.lx = port.executor.factorize_segmented(vals, group=8)
    ref.lx = ref.executor.factorize_segmented(jax.device_put(vals), group=8)
    return port, ref, vals


def _l_ones(solver):
    return solver.factor_csc().to_scipy() @ np.ones(solver.a.n)


@pytest.mark.parametrize("dtype,bar", [("float32", 1e-5),
                                       ("float64", 1e-12)])
def test_pool_row_sums_equal_the_port_factor_times_ones(dtype, bar):
    port, _, _ = _solvers(dtype)
    b = large_run.pool_row_sums(port)
    ref = _l_ones(port)
    assert b.dtype == np.float64 and b.shape == (port.a.n,)
    assert np.max(np.abs(b - ref)) <= bar * np.max(np.abs(ref))


def test_pool_row_sums_equal_the_jax_factor_times_ones():
    port, ref, _ = _solvers("float32")
    b = large_run.pool_row_sums(port)
    want = _l_ones(ref)
    assert np.max(np.abs(b - want)) <= 1e-4 * np.max(np.abs(want))


def test_row_counts_cover_nnz_of_l_and_leave_out_the_stored_inverse():
    """The counts sum to the supernodes' lower trapezoids, h w - w (w -
    1) / 2 each (nnz(L) and the zeros relaxed amalgamation keeps); one
    more column in each diagonal row (the stored ``Linv^T``) would change
    b far beyond the gate."""
    port, _, _ = _solvers("float64")
    plan = port.plan
    lay = plan.layout
    maps = [large_run.row_map(plan, ci) for ci in range(lay.ncls)]
    w = np.diff(lay.part.sptr)
    h = np.diff(lay.rptr)
    stored = int((h * w - w * (w - 1) // 2).sum())
    assert sum(int(cnt.sum()) for _, cnt in maps) == stored
    assert stored >= int(port.cc.sum())
    b = np.zeros(plan.n + 1)
    for ci, (gr, cnt) in enumerate(maps):
        c = port.executor.classes[ci]
        rows = port.lx[ci].view(-1, c).numpy()
        over = np.minimum(cnt + (cnt > 0), c)
        np.add.at(b, gr, np.where(np.arange(c) < over[:, None], rows,
                                  0).sum(1))
    assert np.max(np.abs(b[:-1] - _l_ones(port))) > 1e-3


def test_solve_spd_matches_the_jax_executor():
    port, ref, _ = _solvers("float32")
    ap = port.ap
    full = ap.symmetrize_from_lower().to_scipy()
    b = np.asarray(full @ np.ones(ap.n), dtype=np.float32)
    x = port.executor.solve_spd(port.lx, b).numpy()
    xj = np.asarray(ref.executor.solve_spd(ref.lx, b))
    scale = np.max(np.abs(xj))
    assert np.max(np.abs(x - xj)) <= 1e-4 * scale
    assert large_run.spd_residual(port) == pytest.approx(
        float(np.max(np.abs(x - 1.0))), abs=1e-6)


def _counted_k1(monkeypatch):
    """K1's plain version behind a stand-in that counts as the wrapper
    does, so that the programs' captures count it on the CPU."""
    def k1(D):
        kernels.cholesky_inverse_cuda.launches += 1
        return dense.cholesky_inverse(D)
    monkeypatch.setattr(supernodal, "chol_inverse", k1)


@pytest.fixture(scope="module", params=["host", "device"])
def branch_run(request, tmp_path_factory):
    """``main([out, grid, "--device", "cpu"])`` through one branch (the
    device branch with ``REFERENCE_N`` patched below n), with K1's counted
    stand-in and spies on the steps: (branch, the written line, the
    solver, the unrounded step numbers)."""
    mp = pytest.MonkeyPatch()
    raw = {}
    analyze, factorize = large_run.analyze, large_run.factorize
    solve = large_run.solve

    def spy_analyze(grid, dev):
        out = analyze(grid, dev)
        raw["analyze_s"], raw["solver"] = out[2], out[1]
        return out

    def spy_factorize(solver, dev):
        raw["compile_s"], raw["times"] = factorize(solver, dev)
        return raw["compile_s"], raw["times"]

    def spy_solve(solver, b, dev):
        x, raw["stimes"] = solve(solver, b, dev)
        return x, raw["stimes"]

    try:
        _counted_k1(mp)
        mp.setattr(large_run, "analyze", spy_analyze)
        mp.setattr(large_run, "factorize", spy_factorize)
        mp.setattr(large_run, "solve", spy_solve)
        if request.param == "device":
            mp.setattr(large_run, "REFERENCE_N", 100)
        out = tmp_path_factory.mktemp(request.param) / "line.json"
        large_run.main([str(out), str(_GRID), "--device", "cpu"])
        with open(out) as f:
            line = json.load(f)
    finally:
        mp.undo()
    return request.param, line, raw["solver"], raw


def test_run_through_each_branch_passes_the_gates_with_the_keys(branch_run):
    branch, line, solver, raw = branch_run
    assert list(line) == list(large_run.ART_KEYS + large_run.EXTRA_KEYS)
    assert line["matrix"] == f"laplace_3d({_GRID})" and line["n"] == 512
    assert line["group"] == 8 and line["device"] == "cpu"
    assert line["update_delta"] == ("gather" if branch == "host"
                                    else "scatter")
    assert line["factor_residual"] < 1e-3 and line["trisolve_residual"] < 1e-3
    assert raw["analyze_s"] > 0 and raw["compile_s"] > 0
    assert len(raw["times"]) == large_run.ROUNDS and min(raw["times"]) > 0
    assert line["factorize_s"] == [round(t, 4) for t in sorted(raw["times"])]
    # the rates from the unrounded times (at n = 512 they may round to 0)
    median = sorted(raw["times"])[1]
    smedian = sorted(raw["stimes"])[1]
    assert len(raw["stimes"]) == large_run.ROUNDS and smedian > 0
    flops = solver.plan.flops
    ref_s = flops * 2.429e-10 / 2.0 / 4
    assert line["value"] == round(flops / median / 1e9, 4)
    assert line["vs_baseline"] == round(ref_s / median, 4)
    assert line["trisolve_gnnz_per_s"] == round(
        int(solver.cc.sum()) / smedian / 1e9, 4)
    assert line["native_lib"] is True and line["kernel_build_s"] is None
    assert line["peak_device_gb"] is None
    calls = solver.executor.chol_calls_per_factorize
    assert line["k1_launches_per_factorize"] == \
        line["chol_calls_per_factorize"] == calls > 0
    # on the CPU every factorize runs its closures: the first and ROUNDS
    assert line["k1_launches_run"] == (1 + large_run.ROUNDS) * calls
    assert line["k1_shapes"] == sorted(
        list(s) for s in solver.executor.chol_batch_shapes())
    assert set(line["graph_nodes"]) == set(solver.executor.programs)


def test_device_branch_builds_no_factor_pattern(branch_run):
    """At or above ``REFERENCE_N`` neither L's pattern nor the int64 map
    of ``factor_values`` is built."""
    branch, line, solver, _ = branch_run
    built = (solver._lpat is not None, solver.executor._l_map is not None)
    assert built == ((True, True) if branch == "host" else (False, False))
    assert ("pattern_s" in line["analyze_timings"]) == (branch == "host")


def test_ones_rhs_branches_agree(monkeypatch):
    port, _, _ = _solvers("float32")
    host = large_run.ones_rhs(port)
    monkeypatch.setattr(large_run, "REFERENCE_N", 100)
    dev = large_run.ones_rhs(port)
    assert host.dtype == dev.dtype == np.float32
    assert np.max(np.abs(host - dev)) <= 1e-5 * np.max(np.abs(host))


def test_a_failed_gate_writes_the_line_and_exits_with_the_jax_message(
        monkeypatch, tmp_path):
    monkeypatch.setattr(large_run, "gate", lambda solver, x: (1.0, 0.0))
    out = tmp_path / "line.json"
    with pytest.raises(SystemExit) as e:
        large_run.main([str(out), str(_SMALL), "--device", "cpu"])
    assert e.value.code == "verification failed"
    with open(out) as f:
        assert json.load(f)["factor_residual"] == 1.0


def _jax_script(name):
    return os.path.join(_REPO, "scripts", f"{name}.py")


def _dict_keys(node):
    return tuple(k.value for k in node.keys)


def test_large_run_keys_are_the_jax_scripts():
    """The keys of the dict the JAX script assigns to ``art``, in order."""
    with open(_jax_script("large_run")) as f:
        tree = ast.parse(f.read())
    arts = [node.value for node in ast.walk(tree)
            if isinstance(node, ast.Assign)
            and any(isinstance(t, ast.Name) and t.id == "art"
                    for t in node.targets)]
    assert len(arts) == 1
    assert _dict_keys(arts[0]) == large_run.ART_KEYS
    assert not set(large_run.EXTRA_KEYS) & set(large_run.ART_KEYS)


def test_scale_test_lines_carry_the_jax_scripts_keys(capsys):
    """Each JSON line: the JAX script's keys in its order (read with
    ``ast``), then the port's."""
    with open(_jax_script("scale_test")) as f:
        tree = ast.parse(f.read())
    jax_lines = [_dict_keys(node.args[0]) for node in ast.walk(tree)
                 if isinstance(node, ast.Call)
                 and isinstance(node.func, ast.Attribute)
                 and node.func.attr == "dumps"
                 and isinstance(node.args[0], ast.Dict)]
    assert len(jax_lines) == 3
    scale_test.main([str(_SMALL), "nd", "2", "--device", "cpu"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    extra = [("executor_table_MB", "device"), ("device",), ("device",)]
    assert [tuple(ln) for ln in lines] == [
        k + e for k, e in zip(jax_lines, extra)]
    assert all(ln["device"] == "cpu" for ln in lines)
    assert lines[1]["residual"] < 1e-3 and lines[2]["trisolve_s"] > 0
    assert lines[0]["executor_table_MB"] > 0


class _Captured(Exception):
    pass


def _jax_scale_test_config(monkeypatch, argv):
    """The ``SolverConfig`` the JAX script builds from ``argv``: its main
    runs until its ``CholeskySolver`` is called (without touching JAX's
    global configuration)."""
    spec = importlib.util.spec_from_file_location(
        "jax_scale_test_script", _jax_script("scale_test"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    seen = {}

    def capture(a, cfg):
        seen["cfg"] = cfg
        raise _Captured

    monkeypatch.setattr(jax.config, "update", lambda *a: None)
    monkeypatch.setattr(jax_models, "CholeskySolver", capture)
    monkeypatch.setattr(sys, "argv", ["scale_test.py", *argv])
    with pytest.raises(_Captured):
        mod.main()
    return seen["cfg"]


@pytest.mark.parametrize("knobs", [
    ("width_classes=128", "alpha=1.6", "max_width=64", "segmented=1"),
    ("width_classes=32,128", "chunk_classes=128,16", "q_classes=16,136",
     "nrelax=4,16,48", "zrelax=0.8,0.1,0.05"),
])
def test_scale_test_knobs_give_the_jax_config(monkeypatch, knobs):
    argv = ["4", "amd", "2", *knobs]
    want = _jax_scale_test_config(monkeypatch, argv)
    k, ordering, iters, cfg_kw, segmented, device = scale_test.parse(
        [*argv, "--device", "cpu"])
    assert (k, ordering, iters, device) == (4, "amd", 2, "cpu")
    assert segmented == ("segmented=1" in knobs)
    got = scale_test.config(ordering, cfg_kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got != SolverConfig(ordering="amd", dtype="float32",
                               tier="supernodal")


@pytest.mark.parametrize("module", ["large_run", "scale_test"])
def test_module_without_cuda_exits_nonzero_without_a_line(module):
    """As a user runs it, on a host without CUDA (the tests' host): the
    default device is the card, so there is no line and no fallback."""
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", f"parsy_bench_tpu_torch.scripts.{module}",
         *(["unused.json", "6"] if module == "large_run" else ["6"])],
        cwd=_REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert "CUDA" in out.stderr
    assert not os.path.exists(os.path.join(_REPO, "unused.json"))
