"""The port's sweep drivers
(``parsy_bench_tpu_torch/scripts/{eval,h1_vs_coarse,calibrate_model}.py``)
against the JAX scripts and the JAX package's plans, on the CPU:

* ``eval``: the driver's argument lists that the port's ``main`` builds
  equal the JAX script's for the same arguments (both ``main``s run with
  ``run`` patched to record; the JAX script is loaded by path and imports
  no JAX), the width-cap and ``randspd`` skips included; ``run`` passes
  ``--device`` to ``cholesky`` and ``trisolve`` only; a ``--device cpu``
  sweep of ``gen:laplace3d:6`` as a user runs it, whose lines verify;
* ``h1_vs_coarse``: the JAX script's ``SolverConfig`` (its ``main`` run
  until its ``CholeskySolver`` is called); at ``laplace_3d(8)`` for each
  alpha the port row's ``segments``, ``nlev``, ``table_MB`` and the
  ``gflops`` numerator (``plan.flops``) equal the JAX plan's (no
  compile); for one alpha ``factorize_loop``'s pools equal JAX's within
  1e-4 of the pool scale; the row keys are the JAX script's (``ast``);
* ``calibrate_model``: the JAX script's ``validate`` run on JAX solvers
  with its ``CholeskySolver`` and ``factorize_cost`` recorded; each
  variant's port plan gives the same ``segment_features`` and
  ``factorize_cost(plan, chip).model_s`` with the same ``ChipModel``
  constants passed to both (``slack_placement`` and ``q_classes=(48,136)``
  included); the artifact's keys are the JAX script's (``ast``) and the
  port's; ``all_signs_correct`` follows the measured sign, on stub
  timings;
* without CUDA each module exits non-zero and prints no line.

The subprocesses (the CPU sweep and the three runs without CUDA) start
together when the first test that needs one runs, and each test waits on
its own, so they overlap the in-process tests.  One JAX compile (the
factorize loop).
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
import parsy_bench_tpu.utils.perfmodel as jperf
from parsy_bench_tpu.config import SolverConfig as JaxConfig
from parsy_bench_tpu.core import generate as jax_generate
from parsy_bench_tpu.models import CholeskySolver as JaxSolver
from parsy_bench_tpu_torch import CholeskySolver, SolverConfig
from parsy_bench_tpu_torch.core import generate
from parsy_bench_tpu_torch.scripts import calibrate_model, h1_vs_coarse
from parsy_bench_tpu_torch.scripts import eval as port_eval
from parsy_bench_tpu_torch.utils import calibrate, perfmodel
from test_torch_native import reload_native_libs

reload_native_libs()
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_GRID = 8


def _jax_script(name):
    return os.path.join(_REPO, "scripts", f"{name}.py")


def _load_jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}_script", _jax_script(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dict_keys(node):
    return tuple(k.value for k in node.keys)


# ------------------------------------------------------------ subprocesses
#: name -> (module, arguments); all run from a directory outside the
#: checkout, with PYTHONPATH set to it
_RUNS = {
    "eval_cpu": ("eval", ["gen:laplace3d:6", "--iters", "1",
                          "--device", "cpu"]),
    "eval": ("eval", ["gen:laplace3d:6"]),
    "h1_vs_coarse": ("h1_vs_coarse", ["6"]),
    "calibrate_model": ("calibrate_model", ["6"]),
}


@pytest.fixture(scope="module")
def procs(tmp_path_factory):
    """The subprocesses of ``_RUNS``, started together: name -> (process,
    its working directory, its stdout and stderr files)."""
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="1")
    out = {}
    for name, (module, args) in _RUNS.items():
        cwd = tmp_path_factory.mktemp(name)
        so, se = open(cwd / "stdout", "w+"), open(cwd / "stderr", "w+")
        p = subprocess.Popen(
            [sys.executable, "-m", f"parsy_bench_tpu_torch.scripts.{module}",
             *args], cwd=cwd, env=env, stdout=so, stderr=se, text=True)
        out[name] = (p, cwd, so, se)
    yield out
    for p, _, so, se in out.values():
        if p.poll() is None:
            p.kill()
            p.wait()
        so.close()
        se.close()


def _finish(procs, name, timeout=300):
    """(return code, stdout, stderr, working directory) of a run."""
    p, cwd, so, se = procs[name]
    rc = p.wait(timeout=timeout)
    so.seek(0)
    se.seek(0)
    return rc, so.read(), se.read(), cwd


@pytest.mark.parametrize("module", ["eval", "h1_vs_coarse",
                                    "calibrate_model"])
def test_module_without_cuda_exits_nonzero_without_a_line(procs, module):
    """As a user runs it, on a host without CUDA (the tests' host): the
    default device is the card, so there is no line, no file and no
    fallback."""
    rc, stdout, stderr, cwd = _finish(procs, module)
    assert rc != 0
    assert not [ln for ln in stdout.splitlines() if ln.startswith("{")]
    assert "CUDA" in stderr
    assert sorted(os.listdir(cwd)) == ["stderr", "stdout"]


# -------------------------------------------------------------------- eval
def _commands(main, argv, monkeypatch, mod):
    seen = []
    monkeypatch.setattr(mod, "run", lambda cmd, *a: seen.append(list(cmd)))
    monkeypatch.setattr(sys, "argv", ["eval.py", *argv])
    main()
    return seen


@pytest.mark.parametrize("argv", [
    ["gen:laplace3d:6"],
    ["gen:randspd:300", "gen:laplace2d:8", "--iters", "2", "--trisolve",
     "--baselines"],
    ["a.mtx", "--baselines"],
])
def test_eval_commands_are_the_jax_scripts(monkeypatch, argv):
    jax_eval = _load_jax_script("eval")
    want = _commands(jax_eval.main, argv, monkeypatch, jax_eval)
    got = _commands(lambda: port_eval.main([*argv, "--device", "cpu"]), [],
                    monkeypatch, port_eval)
    assert got == want == port_eval.commands(
        [a for a in argv if not a.startswith("-") and not a.isdigit()],
        int(argv[argv.index("--iters") + 1]) if "--iters" in argv else 5,
        "--baselines" in argv, "--trisolve" in argv)
    chol = [c for c in got if c[0] == "cholesky"]
    # the width cap is swept on the supernodal tier only, and a randspd
    # matrix gets no simplicial run
    for c in chol:
        if c[c.index("--tier") + 1] == "simplicial":
            assert c[c.index("--max-width") + 1] == "128"
            assert "randspd" not in c[1]
    per = {m: sum(c[1] == m for c in chol) for m in {c[1] for c in chol}}
    assert per == {m: (4 if "randspd" in m else 6) for m in per}


def test_eval_run_passes_the_device_to_the_device_commands(monkeypatch,
                                                           capsys):
    calls = []

    def fake(argv, capture_output, text, env):
        calls.append((argv, env["PYTHONPATH"]))
        rc = 1 if argv[3] == "baseline" else 0
        return subprocess.CompletedProcess(argv, rc, 'x\n{"a": 1}\n',
                                           "boom")
    monkeypatch.setattr(port_eval.subprocess, "run", fake)
    for cmd in (["cholesky", "m"], ["trisolve", "m"], ["baseline", "m"]):
        port_eval.run(cmd, "cpu")
    assert [c[0][3:] for c in calls] == [
        ["cholesky", "m", "--device", "cpu"],
        ["trisolve", "m", "--device", "cpu"], ["baseline", "m"]]
    assert all(c[0][1:3] == ["-m", "parsy_bench_tpu_torch.cli"]
               and c[1] == _REPO for c in calls)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines == [{"a": 1}] * 3 + [{"error": ["baseline", "m"],
                                       "stderr": "boom"}]


# ------------------------------------------------------------ h1_vs_coarse
class _Captured(Exception):
    pass


@pytest.fixture(scope="module")
def h1_rows(tmp_path_factory):
    """The port's rows at laplace_3d(8) on the CPU (one loop of one
    factorize per timing, so that the test stays short), and its file."""
    path = tmp_path_factory.mktemp("h1") / "h1.jsonl"
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(h1_vs_coarse, "ITERS", 1)
        mp.setattr(h1_vs_coarse, "ROUNDS", 1)
        rows = h1_vs_coarse.run(_GRID, "nd", "cpu", str(path))
    finally:
        mp.undo()
    with open(path) as f:
        return rows, [json.loads(ln) for ln in f]


@pytest.fixture(scope="module")
def jax_h1_config(tmp_path_factory):
    """The ``SolverConfig`` of the JAX script's first ``CholeskySolver``
    (alpha = ALPHAS[0]): its ``main`` runs, from a scratch directory and
    with JAX's global configuration untouched, until that call."""
    mod = _load_jax_script("h1_vs_coarse")
    seen = {}

    def capture(a, cfg):
        seen["cfg"] = cfg
        raise _Captured
    mp = pytest.MonkeyPatch()
    try:
        mp.chdir(tmp_path_factory.mktemp("jax_h1"))
        mp.setattr(jax.config, "update", lambda *a: None)
        mp.setattr(jax_models, "CholeskySolver", capture)
        mp.setattr(sys, "argv", ["h1_vs_coarse.py", str(_GRID), "nd"])
        with pytest.raises(_Captured):
            mod.main()
    finally:
        mp.undo()
    assert (mod.ALPHAS, mod.ITERS) == (h1_vs_coarse.ALPHAS,
                                       h1_vs_coarse.ITERS)
    return seen["cfg"]


def test_h1_config_is_the_jax_scripts(jax_h1_config):
    assert jax_h1_config.segment_alpha == h1_vs_coarse.ALPHAS[0]
    assert (dataclasses.asdict(h1_vs_coarse.config("nd",
                                                   h1_vs_coarse.ALPHAS[0]))
            == dataclasses.asdict(jax_h1_config))


@pytest.mark.parametrize("k", range(len(h1_vs_coarse.ALPHAS)))
def test_h1_row_plan_matches_jax(h1_rows, jax_h1_config, k):
    alpha = h1_vs_coarse.ALPHAS[k]
    rows, written = h1_rows
    row = rows[k]
    assert written[k] == row and row["segment_alpha"] == alpha
    ref = JaxSolver(jax_generate.laplace_3d(_GRID),
                    jax_h1_config.replace(segment_alpha=alpha))
    assert (row["segments"], row["nlev"], row["table_MB"]) == (
        len(ref.plan.segments), ref.plan.nlev,
        round(ref.plan.table_bytes() / 1e6, 1))
    port = CholeskySolver(generate.laplace_3d(_GRID),
                          h1_vs_coarse.config("nd", alpha), device="cpu")
    assert port.plan.flops == ref.plan.flops
    assert row["schedule"] == ("wavefront-H1" if alpha <= 1.0
                               else "coarsened")
    assert row["residual"] < 1e-3 and row["factorize_s"] > 0
    assert row["device"] == "cpu" and row["k1_launches_per_factorize"] == 0


def test_h1_factorize_loop_matches_jax(jax_h1_config):
    """At laplace_3d(6), which keeps the JAX compile short."""
    alpha = h1_vs_coarse.ALPHAS[1]
    port = CholeskySolver(generate.laplace_3d(6),
                          h1_vs_coarse.config("nd", alpha), device="cpu")
    ref = JaxSolver(jax_generate.laplace_3d(6),
                    jax_h1_config.replace(segment_alpha=alpha))
    data = port.ap.data.astype(np.float32)
    np.testing.assert_array_equal(data, ref.ap.data.astype(np.float32))
    got = port.executor.factorize_loop(data, h1_vs_coarse.ITERS)
    want = jax.block_until_ready(ref.executor.factorize_loop(
        data, h1_vs_coarse.ITERS))
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-4 * scale


def test_h1_row_keys_are_the_jax_scripts(h1_rows):
    with open(_jax_script("h1_vs_coarse")) as f:
        tree = ast.parse(f.read())
    dicts = [node.value for node in ast.walk(tree)
             if isinstance(node, ast.Assign)
             and any(isinstance(t, ast.Name) and t.id == "row"
                     for t in node.targets)]
    assert len(dicts) == 1
    assert _dict_keys(dicts[0]) == h1_vs_coarse.ROW_KEYS
    keys = h1_vs_coarse.ROW_KEYS + h1_vs_coarse.EXTRA_KEYS
    assert all(tuple(r) == keys for r in h1_rows[0])


# --------------------------------------------------------- calibrate_model
@functools.lru_cache(maxsize=None)
def _jax_validation():
    """The JAX script's ``validate`` on a JAX solver at laplace_3d(8) under
    the JAX ``ChipModel``'s constants: per variant name its config, plan
    and unrounded ``model_s`` (``CholeskySolver`` and ``factorize_cost``
    recorded), the base plan's ``model_s`` and its result."""
    mod = _load_jax_script("calibrate_model")
    base = JaxSolver(jax_generate.laplace_3d(_GRID),
                     JaxConfig(ordering="nd", dtype="float32",
                               tier="supernodal"))
    cfgs, costs = [], []
    real_cost = jperf.factorize_cost

    def solver(a, cfg):
        cfgs.append(cfg)
        return JaxSolver(a, cfg)

    def cost(plan, chip=None):
        r = real_cost(plan, chip)
        costs.append((plan, r.model_s))
        return r
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jax_models, "CholeskySolver", solver)
        mp.setattr(jperf, "factorize_cost", cost)
        out = mod.validate(base, jperf.ChipModel())
    finally:
        mp.undo()
    names = list(out["signs"])
    return dict(base_model_s=costs[0][1], out=out,
                variants={n: (c, p, m) for n, c, (p, m)
                          in zip(names, cfgs, costs[1:])})


def _port_chip():
    consts = {f.name: getattr(jperf.ChipModel(), f.name)
              for f in dataclasses.fields(jperf.ChipModel)}
    return perfmodel.ChipModel(**consts)


def _base_cfg():
    return SolverConfig(ordering="nd", dtype="float32", tier="supernodal")


@pytest.mark.parametrize("name", list(calibrate_model.VARIANTS))
def test_variant_plan_and_model_match_jax(name):
    ref = _jax_validation()
    assert list(ref["variants"]) == list(calibrate_model.VARIANTS)
    jcfg, jplan, jmodel = ref["variants"][name]
    cfg = _base_cfg().replace(**calibrate_model.VARIANTS[name])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    port = CholeskySolver(generate.laplace_3d(_GRID), cfg, device="cpu")
    plan = port.plan
    assert len(plan.segments) == len(jplan.segments)
    for sp, sj in zip(plan.segments, jplan.segments):
        assert (perfmodel.segment_features(sp, plan.classes)
                == jperf.segment_features(sj, jplan.classes))
    assert perfmodel.factorize_cost(plan, _port_chip()).model_s == jmodel
    base = CholeskySolver(generate.laplace_3d(_GRID), _base_cfg(),
                          device="cpu")
    assert (perfmodel.factorize_cost(base.plan, _port_chip()).model_s
            == ref["base_model_s"])


def test_artifact_keys_are_the_jax_scripts(monkeypatch):
    with open(_jax_script("calibrate_model")) as f:
        tree = ast.parse(f.read())

    def assigned(target):
        return [node.value for node in ast.walk(tree)
                if isinstance(node, ast.Assign)
                and any(ast.unparse(t) == target for t in node.targets)]
    arts = assigned("art")
    signs = assigned("out['signs'][name]")
    assert len(arts) == len(signs) == 1
    assert _dict_keys(arts[0]) == calibrate_model.ART_KEYS
    assert _dict_keys(signs[0]) == calibrate_model.SIGN_KEYS
    collect = calibrate.collect
    monkeypatch.setattr(calibrate, "collect",
                        lambda s: collect(s, iters=1, reps=1))
    art = calibrate_model.run(_GRID, "cpu", pairs=2,
                              sample=lambda s, d: 1.0)
    assert tuple(art) == (calibrate_model.ART_KEYS
                          + calibrate_model.EXTRA_KEYS)
    val = art["validation"]
    assert list(val) == ["base_model_s", "signs", "all_signs_correct"]
    assert list(val["signs"]) == list(calibrate_model.VARIANTS)
    for s in val["signs"].values():
        assert tuple(s) == (calibrate_model.SIGN_KEYS
                            + calibrate_model.SIGN_EXTRA_KEYS)
        assert s["gates"]["passed"] and s["pairs"]["pairs"] == 2
    assert art["segments"] == len(CholeskySolver(
        generate.laplace_3d(_GRID), _base_cfg(), device="cpu").plan.segments)
    assert art["device"] == "cpu" and set(art["fitted"]) == set(
        calibrate.COLUMNS) | {"_fit_r2", "_residual_s"}


@pytest.mark.parametrize("flip", [(), ("q_classes=(48,136)",),
                                  tuple(calibrate_model.VARIANTS)])
def test_all_signs_correct_follows_the_measured_sign(flip):
    """Stub timings: the card measures each variant as the model ranks it,
    except the variants in ``flip``."""
    base = CholeskySolver(generate.laplace_3d(_GRID), _base_cfg(),
                          device="cpu")
    chip = _port_chip()
    t_base = perfmodel.factorize_cost(base.plan, chip).model_s
    model_slower = {}
    for name, kw in calibrate_model.VARIANTS.items():
        plan = CholeskySolver(generate.laplace_3d(_GRID),
                              _base_cfg().replace(**kw), device="cpu").plan
        slower = perfmodel.factorize_cost(plan, chip).model_s > t_base
        model_slower[name] = slower != (name in flip)

    def sample(solver, data):
        if solver is base:
            return 1.0
        name = next(n for n, kw in calibrate_model.VARIANTS.items()
                    if all(getattr(solver.config, k) == v
                           for k, v in kw.items()))
        return 2.0 if model_slower[name] else 0.5
    val = calibrate_model.validate(base, chip, pairs=2, sample=sample)
    for name, s in val["signs"].items():
        assert s["measured_ranks_default_faster"] == model_slower[name]
        assert s["pairs"]["default_faster_in"] == (
            2 if model_slower[name] else 0)
        assert s["measured_gflops"] == pytest.approx(
            base.plan.flops / (2.0 if model_slower[name] else 0.5) / 1e9)
    assert val["all_signs_correct"] == (not flip)


def test_chip_model_is_named_after_the_card():
    fitted = {c: 1.0 for c in calibrate.COLUMNS}
    chip = calibrate_model.chip_model(fitted, "NVIDIA H100 80GB HBM3, 700 W")
    assert chip.name == "NVIDIA H100 80GB HBM3, 700 W calibrate_model fit"
    assert all(getattr(chip, c) == 1.0 for c in calibrate.COLUMNS)


def test_eval_on_the_cpu_lines_verify(procs):
    """``gen:laplace3d:6 --iters 1 --device cpu`` from outside the
    checkout: both tiers, both orderings, the supernodal widths; every
    line verifies."""
    rc, stdout, stderr, _ = _finish(procs, "eval_cpu")
    assert rc == 0, stderr
    lines = [json.loads(ln) for ln in stdout.splitlines()]
    assert [(ln["tier"], ln["ordering"]) for ln in lines] == [
        ("simplicial", "amd"), ("simplicial", "nd")] + [
        ("supernodal", o) for o in ("amd", "amd", "nd", "nd")]
    for ln in lines:
        assert ln["driver"] == "cholesky" and ln["device"] == "cpu"
        assert ln["n"] == 216 and ln["iters"] == 1
        assert ln["factor_residual"] < 1e-3 and ln["solve_residual"] < 1e-3
