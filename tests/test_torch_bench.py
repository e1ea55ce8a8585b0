"""The port's headline benchmark (``parsy_bench_tpu_torch/bench.py``) on
the CPU: ``bench.py``'s keys, gates and baselines, its solve against the
JAX package's, and no fallback (a failed gate, capture or card raises)."""
import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax

# as in every test file that shares a worker with JAX f64 tests
jax.config.update("jax_enable_x64", True)

import torch

import bench as jax_bench
from parsy_bench_tpu.config import SolverConfig as JaxConfig
from parsy_bench_tpu.core import generate as jax_generate
from parsy_bench_tpu.models import CholeskySolver as JaxSolver
from parsy_bench_tpu_torch import bench
from parsy_bench_tpu_torch.models import CholeskySolver
from parsy_bench_tpu_torch.ops.supernodal import SupernodalExecutor
from test_torch_native import reload_native_libs

# a test process that lost a native library's first-build race loads it
# now, so both packages' inspectors run native
reload_native_libs()

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CPU = torch.device("cpu")
#: the grid of the gate and fallback cases
_SMALL = 6


def _jax_plan(grid):
    return JaxSolver(jax_generate.laplace_3d(grid), JaxConfig(
        ordering="nd", dtype="float32", tier="supernodal"))


@pytest.fixture(scope="module")
def line10():
    """``run(grid=10, device="cpu")``'s line, with the unrounded analyze,
    compile and factorize seconds its steps returned."""
    raw = {}
    mp = pytest.MonkeyPatch()
    analyze, factorize = bench.analyze, bench.factorize

    def spy_analyze(grid, dev):
        out = analyze(grid, dev)
        raw["analyze_s"] = out[2]
        raw["plan"] = out[1].plan
        return out

    def spy_factorize(solver, dev):
        raw["compile_s"], raw["times"] = factorize(solver, dev)
        return raw["compile_s"], raw["times"]

    mp.setattr(bench, "analyze", spy_analyze)
    mp.setattr(bench, "factorize", spy_factorize)
    try:
        line = bench.run(grid=10, device="cpu")
    finally:
        mp.undo()
    return line, raw


def test_run_on_the_cpu_passes_the_gates_with_the_keys(line10):
    line, raw = line10
    assert set(line) == set(bench.BENCH_KEYS) | set(bench.EXTRA_KEYS)
    assert len(line) == len(bench.BENCH_KEYS) + len(bench.EXTRA_KEYS)
    assert line["n"] == 1000 and line["group"] == 16
    assert line["metric"] == "supernodal_cholesky_factorize_gflops"
    assert line["unit"] == "GFLOP/s"
    assert line["factor_residual"] < 1e-3 and line["trisolve_residual"] < 1e-3
    assert line["device"] == "cpu" and line["kernel_build_s"] is None
    assert line["torch"] == torch.__version__
    assert line["cuda"] == torch.version.cuda
    assert line["update_delta"] == "gather" and line["native_lib"] is True
    # bench.py rounds analyze_s and compile_s to 0.1 s: at n = 1000 they
    # are checked unrounded, and their rounding in the line
    assert raw["analyze_s"] > 0 and raw["compile_s"] > 0
    assert line["analyze_s"] == round(raw["analyze_s"], 1)
    assert line["compile_s"] == round(raw["compile_s"], 1)
    assert len(raw["times"]) == 5 and min(raw["times"]) > 0
    assert all(t > 0 for t in line["factorize_s_min_med_max"])
    assert line["residual_s"] > 0
    for k in ("value", "vs_baseline", "trisolve_gnnz_per_s",
              "trisolve_vs_baseline", "trisolve_vs_ref_model"):
        assert line[k] > 0, k
    json.dumps(line)


def test_bench_keys_are_the_keys_of_bench_py():
    """Read from the text of ``bench.py``: the keys of the dict its final
    ``json.dumps`` prints, in order."""
    with open(os.path.join(_REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    dumps = [node for node in ast.walk(tree)
             if isinstance(node, ast.Call)
             and isinstance(node.func, ast.Attribute)
             and node.func.attr == "dumps"]
    keys = tuple(k.value for k in dumps[-1].args[0].keys)
    assert keys == bench.BENCH_KEYS
    assert not set(bench.EXTRA_KEYS) & set(keys)


def test_port_bench_imports_not_the_root_bench():
    with open(bench.__file__) as f:
        tree = ast.parse(f.read())
    names = [a.name for node in ast.walk(tree)
             if isinstance(node, ast.Import) for a in node.names]
    names += [node.module for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module]
    assert not [n for n in names
                if n.split(".")[0] in ("bench", "jax", "jaxlib",
                                       "parsy_bench_tpu")], names


def test_baselines_match_bench_py_on_the_jax_plan(line10):
    """The hardware-independent numbers: the reference's trisolve model
    and the flops on the port's plan against ``bench.py``'s on the JAX
    package's plan, and the line's factorize rate and ``vs_baseline``
    from them and the measured median, to the line's rounding."""
    line, raw = line10
    plan = raw["plan"]
    jplan = _jax_plan(10).plan
    assert (bench._REF_SEC_PER_FLOP, bench._REF_THREADS, bench._ITERS,
            bench._GRID) == (jax_bench._REF_SEC_PER_FLOP,
                             jax_bench._REF_THREADS, jax_bench._ITERS,
                             jax_bench._GRID)
    ref = jax_bench._ref_trisolve_model_s(jplan)
    assert bench._ref_trisolve_model_s(plan) == pytest.approx(
        ref, rel=1e-12, abs=0)
    assert plan.flops == jplan.flops
    times = raw["times"]
    median = sorted(times)[2]
    ref_time = jplan.flops * jax_bench._REF_SEC_PER_FLOP / \
        jax_bench._REF_THREADS
    assert line["vs_baseline"] == round(ref_time / median, 4)
    assert line["value"] == round(jplan.flops / median / 1e9, 4)
    assert line["factorize_s_min_med_max"] == [
        round(min(times), 4), round(median, 4), round(max(times), 4)]


def test_solve_matches_the_jax_package():
    """x of b = L*1 after ``factorize_segmented(group=16)`` and
    ``solve_loop(..., 5)``: the port's bench steps against the JAX
    package's executor on the same grid and b, within 1e-5."""
    a, solver, _ = bench.analyze(10, _CPU)
    bench.factorize(solver, _CPU)
    _, b = bench.rhs(solver)
    x, _ = bench.solve(solver, b, _CPU)
    js = _jax_plan(10)
    np.testing.assert_array_equal(js.ap.data, solver.ap.data)
    jex = js.executor
    jlx = jex.factorize_segmented(
        jax.device_put(js.ap.data.astype(np.float32)), group=16)
    xj = np.asarray(jex.solve_loop(jlx, b, 5))
    assert x.shape == xj.shape == (a.n,)
    np.testing.assert_allclose(x, xj, rtol=0, atol=1e-5)
    assert np.max(np.abs(x - 1.0)) < 1e-3


@pytest.mark.parametrize("gate", ["factor", "solve"])
def test_a_failed_gate_exits_nonzero_with_bench_py_message(monkeypatch,
                                                            gate):
    if gate == "factor":
        monkeypatch.setattr(CholeskySolver, "factor_residual",
                            lambda self: 1.0)
        msg = "factor residual 1.000e+00 exceeds 1e-3 — benchmark invalid"
    else:
        solve_loop = SupernodalExecutor.solve_loop
        monkeypatch.setattr(
            SupernodalExecutor, "solve_loop",
            lambda self, *args: solve_loop(self, *args) + 1.0)
        msg = "trisolve error 1.000e+00 exceeds 1e-3 — benchmark invalid"
    with pytest.raises(SystemExit) as e:
        bench.run(grid=_SMALL, device="cpu")
    # a string code: the interpreter prints it and exits with 1
    assert e.value.code == msg


def test_a_failed_factorize_raises_and_is_not_retried(monkeypatch):
    groups = []

    def fail(self, a_data, group=8):
        groups.append(group)
        raise RuntimeError("capture failed")

    monkeypatch.setattr(SupernodalExecutor, "factorize_segmented", fail)
    with pytest.raises(RuntimeError, match="capture failed"):
        bench.run(grid=_SMALL, device="cpu")
    assert groups == [16]


def test_module_without_cuda_exits_nonzero_without_a_line():
    """As a user runs it, on a host without CUDA (the tests' host): the
    default device is the card, so there is no line and no fallback."""
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "parsy_bench_tpu_torch.bench"],
                         cwd=_REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert "CUDA" in out.stderr
