"""A run of each cell, at a tiny grid on the CPU, gives the benchmark's
result line with the cell's metrics; the command refuses a machine without
CUDA; no run holds a module of JAX or of the JAX package."""
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest

from benchmark import harness
from benchmark.steps import factor_solve
from benchmark.tests.common import ROOT, SEED, bench, run_tiny, tiny_cell

B = bench()
CELLS = [w["name"] for w in B["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", CELLS)
def test_untraced_run_line(name):
    out = run_tiny(name)
    assert list(out)[:5] == KEYS and list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    cell = harness.find_cell(B, name)
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        got = out["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and got["value"] > 0
    assert json.loads(json.dumps(out)) == out


@pytest.mark.parametrize("name", CELLS[:1] + CELLS[2:3])
def test_traced_run_line(name):
    """On the CPU the trace holds no device operation: the device metrics
    are left out, never written from host times."""
    out = run_tiny(name, traced=True)
    assert out["correct"] is True
    cell = harness.find_cell(B, name)
    names = {m["name"] for m in cell.per_layer}
    assert set(out["metrics"]) == {"analyze_s", "capture_s"} <= names
    assert "busy_s" not in out["device"] and "breakdown" not in out


def test_same_seed_same_inputs():
    cell = tiny_cell(CELLS[0])
    make = cell.steps.make_inputs
    a, b, c = make(cell, SEED), make(cell, SEED), make(cell, SEED + 1)
    for x, y, z in zip(a.values + a.rhs, b.values + b.rhs, c.values + c.rhs):
        assert np.array_equal(x, y) and x.shape == z.shape
        assert not np.array_equal(x, z)


def test_steps_cycle_the_pools():
    mix = {"refactor": True}
    assert [factor_solve.step_plan(mix, k, 4, 4) for k in range(5)] == [
        (0, 0), (1, 1), (2, 2), (3, 3), (0, 0)]
    mix = {"refactor": False}
    assert [factor_solve.step_plan(mix, k, 1, 3) for k in range(4)] == [
        (None, 0), (None, 1), (None, 2), (None, 0)]


def test_sample_is_drawn_from_the_seed():
    def kept(seed):
        s = harness.Sample(4, seed)
        for k in range(100):
            s.offer((k,))
        return sorted(s.kept)
    assert kept(SEED) == kept(SEED) and len(kept(SEED)) == 4
    assert kept(SEED) != kept(SEED + 1)


def test_step_stats():
    st = harness.step_stats([0.1] * 19 + [1.0], 2.9)
    assert st["mean_ms"] == pytest.approx(145.0)
    assert st["p95_ms"] == pytest.approx(145.0)
    assert harness.step_stats([], 1.0) == {}


def test_command_refuses_a_machine_without_cuda():
    """This sandbox has no card: exit non-zero, no result line."""
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_a_run_loads_nothing_of_jax():
    """A tiny run in a fresh process: no module whose top-level name is
    jax, jaxlib, flax or parsy_bench_tpu (compared whole), and the port
    is what ran."""
    code = (
        "import sys, json\n"
        "from benchmark.tests.common import run_tiny\n"
        "from benchmark import harness\n"
        f"out = run_tiny({CELLS[0]!r})\n"
        "print(json.dumps([harness.forbidden_modules(), out['correct'],\n"
        "                  'parsy_bench_tpu_torch' in sys.modules]))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    bad, correct, port = json.loads(proc.stdout.strip().splitlines()[-1])
    assert bad == [] and correct and port


def test_a_loaded_jax_module_stops_the_run(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(harness.ForbiddenModules) as e:
        run_tiny(CELLS[2])
    assert e.value.names == ["jax"]


@pytest.fixture
def stub_jax(tmp_path, monkeypatch):
    """A module named ``jax`` that an import finds; gone after the test."""
    (tmp_path / "jax.py").write_text("")
    monkeypatch.syspath_prepend(str(tmp_path))
    yield
    sys.modules.pop("jax", None)


def _imports_jax(*args, **kw):
    import jax  # noqa: F401 - the planted import
    return None


@pytest.mark.parametrize("where", ["metric", "check"])
def test_jax_loaded_after_the_window_stops_the_run(where, stub_jax,
                                                   monkeypatch):
    """A metric's reader or the check that imports jax once the window has
    closed gives no result."""
    cell = tiny_cell(CELLS[0])
    if where == "metric":
        monkeypatch.setattr(harness, "load_metric", lambda name: types.
                            SimpleNamespace(read=_imports_jax))
    else:
        check = cell.steps.check
        monkeypatch.setattr(cell.steps, "check", lambda *a: (
            _imports_jax(), check(*a))[1])
    assert "jax" not in sys.modules
    with pytest.raises(harness.ForbiddenModules) as e:
        harness.run(cell, SEED, 0.5, where == "metric", "cpu",
                    time.perf_counter())
    assert e.value.names == ["jax"]


def test_run_exits_3_with_no_line_on_forbidden_modules(monkeypatch, capsys):
    from benchmark import run as run_py

    def run(*a, **kw):
        raise harness.ForbiddenModules(["jax"])
    monkeypatch.setattr(harness, "run", run)
    monkeypatch.setattr(run_py, "_cuda_cards", lambda: 1)
    assert run_py.main(["--workload", CELLS[0], "--seed", str(SEED),
                        "--seconds", "1", "--trace", "0"]) == 3
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "parsy_bench_tpu_torch_extra",
                        types.ModuleType("parsy_bench_tpu_torch_extra"))
    monkeypatch.setitem(sys.modules, "jaxfoo", types.ModuleType("jaxfoo"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "parsy_bench_tpu.core",
                        types.ModuleType("parsy_bench_tpu.core"))
    assert harness.forbidden_modules() == ["parsy_bench_tpu.core"]
