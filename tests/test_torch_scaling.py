"""The port's scaling driver (``parsy_bench_tpu_torch/scripts/scaling.py``)
and the rank profiler it reads, against the JAX script and the JAX
package, on the CPU:

* the driver run as a user runs it, ``python -m
  parsy_bench_tpu_torch.scripts.scaling 10 <out> --device cpu`` (G = 1 in
  process, G = 2, 4 and 8 in gloo rank processes): its artifact's keys,
  a row per G with the JAX row's keys and the port's, the architecture
  keys equal to what the JAX package's ``build_dist_plan`` gives on the
  same matrix and configuration (host only, no JAX compile), the ring
  bytes equal to the plan's model, the efficiency formulas, every rank
  free of JAX; G = 8's architecture keys also from its plan alone;
* the JAX script's row and artifact keys (``ast``);
* without CUDA and without ``--device cpu`` the driver exits non-zero and
  writes nothing;
* ``comm.rank_layout``: gloo on the CPU, NCCL with one card per rank only
  where there are G cards;
* ``parallel/runs``' profiled first factorize goes through
  ``scripts/attribution.profile`` (torch.profiler stubbed), and its K1 and
  ``psum`` counts are those of one factorize; the ranks take the
  profiler's retries together (``agree``).

The two subprocesses start together when the first test that needs them
runs, and each test waits on its own, so they overlap the in-process
tests.
"""
import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from parsy_bench_tpu.config import SolverConfig as JaxConfig
from parsy_bench_tpu.core import generate as jax_generate
from parsy_bench_tpu.models import CholeskySolver as JaxSolver
from parsy_bench_tpu.symbolic import dplan as jax_dplan
from parsy_bench_tpu_torch.ops import kernels, supernodal
from parsy_bench_tpu_torch.parallel import comm, runs
from parsy_bench_tpu_torch.parallel.dist import DistExecutor
from parsy_bench_tpu_torch.scripts import attribution, scaling
from parsy_bench_tpu_torch.symbolic.dplan import build_dist_plan
from test_torch_native import reload_native_libs

reload_native_libs()
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_GRID = 10
_CPU = torch.device("cpu")

#: name -> arguments of ``python -m parsy_bench_tpu_torch.scripts.scaling``
_RUNS = {"cpu": [str(_GRID), "out.json", "--device", "cpu"],
         "no_device": ["6", "out.json"]}


@pytest.fixture(scope="module")
def procs(tmp_path_factory):
    """The runs of ``_RUNS``, started together from directories outside
    the checkout: name -> (process, its directory, stdout, stderr)."""
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="1")
    out = {}
    for name, args in _RUNS.items():
        cwd = tmp_path_factory.mktemp(f"scaling_{name}")
        so, se = open(cwd / "stdout", "w+"), open(cwd / "stderr", "w+")
        p = subprocess.Popen(
            [sys.executable, "-m", "parsy_bench_tpu_torch.scripts.scaling",
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
    rc = p.wait(timeout)
    so.seek(0)
    se.seek(0)
    return rc, so.read(), se.read(), cwd


@pytest.fixture(scope="module")
def art(procs):
    rc, out, err, cwd = _finish(procs, "cpu")
    assert rc == 0, err[-3000:]
    with open(cwd / "out.json") as f:
        return json.load(f), out


@pytest.fixture(scope="module")
def solvers():
    """(the port's solver, the JAX solver) of the driver's configuration
    at ``laplace_3d(_GRID)``, each from its own package (no compile)."""
    port = scaling.analyze(_GRID, _CPU)
    ref = JaxSolver(jax_generate.laplace_3d(_GRID),
                    JaxConfig(ordering="nd", dtype="float32",
                              tier="supernodal", update_delta="scatter"))
    assert np.array_equal(port.perm, ref.perm)
    return port, ref


def _jax_keys(ref, g) -> dict:
    """The JAX script's architecture keys (scripts/scaling.py:65-85) from
    the JAX package's plans."""
    if g == 1:
        return dict(psum_bytes_per_device_per_factorize=0.0,
                    solve_psum_bytes={},
                    pool_bytes_per_device=ref.plan.pool_elems() * 4,
                    cross_row_fraction=0.0)
    dp = jax_dplan.build_dist_plan(ref.ap, ref.parent, ref.cc, g, ref.config)
    pm = dp.psum_bytes_per_step()
    return dict(psum_bytes_per_device_per_factorize=pm["factorize_bytes"],
                solve_psum_bytes={k: pm[k] for k in
                                  ("solve_lower_bytes", "solve_upper_bytes",
                                   "solve_r4_design_bytes",
                                   "receive_min_bytes")},
                pool_bytes_per_device=dp.pool_elems_per_device() * 4,
                cross_row_fraction=dp.comm["row_fraction_cross"])


def _port_plan(port, g):
    if g == 1:
        return port.plan
    return build_dist_plan(port.ap, port.parent, port.cc, g, port.config)


# ------------------------------------------------------ the JAX script
def _jax_script_tree():
    with open(os.path.join(_REPO, "scripts", "scaling.py")) as f:
        return ast.parse(f.read())


def test_row_keys_are_the_jax_scripts():
    """``ROW_KEYS``: the keys of the JAX row (its ``print("ROW " +
    json.dumps({...}))``) and the two efficiencies it adds, in order;
    ``ART_KEYS``: the JAX artifact's keys, then ``card``."""
    tree = _jax_script_tree()
    dicts = [n for n in ast.walk(tree) if isinstance(n, ast.Dict)
             and n.keys and all(isinstance(k, ast.Constant) for k in n.keys)]
    keys = [tuple(k.value for k in d.keys) for d in dicts]
    row = next(k for k in keys if k[0] == "g" and "nnz_l" in k)
    art = next(k for k in keys if k[0] == "matrix")
    added = [n.slice.value for n in ast.walk(tree)
             if isinstance(n, ast.Subscript) and isinstance(n.ctx, ast.Store)
             and isinstance(n.value, ast.Name) and n.value.id == "row"]
    assert scaling.ROW_KEYS == row + tuple(added)
    assert scaling.ART_KEYS == art + ("card",)


# -------------------------------------------------- architecture keys
@pytest.mark.parametrize("g", [1, 2, 4, 8])
def test_plan_keys_match_jax(procs, solvers, g):
    """The architecture keys from the port's plan alone (no launch) equal
    the JAX package's for the same matrix and configuration."""
    port, ref = solvers
    assert scaling.plan_keys(_port_plan(port, g)) == _jax_keys(ref, g)


@pytest.mark.parametrize("g", [1, 2, 4, 8])
def test_driver_rows_match_jax(art, solvers, g):
    """The driver's row of G (G = 2 and 4 launched, as is 8) holds the
    JAX package's architecture keys, n and nnz(L)."""
    port, ref = solvers
    row = next(r for r in art[0]["rows"] if r["g"] == g)
    assert {k: row[k] for k in _jax_keys(ref, g)} == _jax_keys(ref, g)
    assert (row["n"], row["nnz_l"]) == (int(ref.a.n), int(ref.cc.sum()))


def test_ring_bytes_equal_the_model(art, solvers):
    """At every G > 1 the ranks' measured payload, times 2 (G - 1) / G, is
    the plan's ``factorize_bytes``; ``ring_check`` raises on a miss."""
    port, _ = solvers
    for row in art[0]["rows"][1:]:
        g = row["g"]
        assert (row["psum_payload_bytes"] * 2.0 * (g - 1) / g
                == row["psum_bytes_per_device_per_factorize"] > 0)
        plan = _port_plan(port, g)
        assert scaling.ring_check(plan, row["psum_payload_bytes"]) > 0
        with pytest.raises(AssertionError, match="ring bytes"):
            scaling.ring_check(plan, row["psum_payload_bytes"] + 4)
    assert art[0]["rows"][0]["psum_payload_bytes"] == 0


# ------------------------------------------------------ the artifact
def test_main_writes_the_artifact(art):
    """``main`` with ``--device cpu`` writes the JAX artifact's keys and
    ``card``, a row per G in 1, 2, 4, 8 with the JAX row's keys then the
    port's, and prints each row and the file's name."""
    a, out = art
    assert tuple(a) == scaling.ART_KEYS
    assert a["matrix"] == f"laplace_3d({_GRID})" and a["n"] == _GRID ** 3
    assert a["card"] == "cpu" and "gloo" in a["backend"]
    assert [r["g"] for r in a["rows"]] == list(scaling.GROUPS)
    for r in a["rows"]:
        assert tuple(r) == scaling.ROW_KEYS + scaling.EXTRA_KEYS
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert lines == a["rows"]
    assert out.splitlines()[-1] == "wrote out.json"


def test_efficiency_formulas(art):
    """The JAX script's efficiencies (scripts/scaling.py:141-143) against
    the G = 1 factorize, and the port's against the ranks' devices."""
    rows = art[0]["rows"]
    t1 = rows[0]["factorize_s"]
    for r in rows:
        g, tg = r["g"], r["factorize_s"]
        assert r["efficiency_vs_g1"] == t1 / (g * tg)
        assert r["efficiency_vs_core_ceiling"] == t1 / (
            min(g, r["cores"]) * tg)
        assert r["efficiency_vs_card_ceiling"] == t1 / (
            min(g, r["cards"]) * tg)
        assert r["factorize_mnnz_per_s"] == r["nnz_l"] / tg / 1e6
        assert r["compile_s"] > 0 and r["solve_s"] > 0 and tg > 0
    assert rows[0]["efficiency_vs_g1"] == 1.0


def test_every_rank_is_jax_free_and_counted(art):
    """Each row has a record per rank: free of JAX, its K1 launches (0:
    the plain version runs on the CPU) and no device busy time (not
    measured on the CPU); the ranks shared one device over gloo."""
    for r in art[0]["rows"]:
        g = r["g"]
        assert r["jax_free"] == [True] * g
        assert r["k1_launches"] == [0] * g
        assert r["device_busy_ms"] == [None] * g
        assert r["chol_calls_per_factorize"] > 0 and r["cards"] == 1
        assert r["backend"] == (None if g == 1 else "gloo")


def test_without_cuda_the_driver_raises(procs):
    """Without ``--device cpu`` the driver asks for the card: here it
    exits non-zero, names CUDA, prints no row and writes no file."""
    rc, out, err, cwd = _finish(procs, "no_device")
    assert rc != 0 and "CUDA" in err
    assert "{" not in out and not (cwd / "out.json").exists()


# --------------------------------------------------------- rank layout
def test_rank_layout(monkeypatch):
    """gloo with every rank on the CPU; on a card NCCL with a card per
    rank where the machine has G cards, else gloo all on the first;
    CUDA without a card raises."""
    assert comm.rank_layout(4, "cpu") == ("gloo", [_CPU] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            comm.rank_layout(2, "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert comm.rank_layout(4, "cuda") == (
        "nccl", [torch.device("cuda", r) for r in range(4)])
    assert comm.rank_layout(8, "cuda") == (
        "gloo", [torch.device("cuda", 0)] * 8)


# ------------------------------------------------ the profiled factorize
class _OneRank(comm.Group):
    """A group of one rank: ``psum`` counts and leaves ``t`` as it is (the
    sum over one rank)."""

    def psum(self, t):
        self.calls += 1
        self.nbytes += t.numel() * t.element_size()
        return t


class _Profile:
    """torch.profiler's ``profile`` stand-in: no events."""

    def __init__(self, *a, **kw):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def events(self):
        return []


def test_profiled_first_factorize_counts_one_factorize(monkeypatch):
    """With ``profile`` the rank's first factorize goes through
    ``attribution.profile`` (an unprofiled call, then the profiled one),
    and its K1 launches and ``psum`` calls and bytes are one factorize's:
    those of the same rank without the profile."""
    port = scaling.analyze(6, _CPU)
    plan = build_dist_plan(port.ap, port.parent, port.cc, 1, port.config)
    data = port.ap.data.astype(np.float32)
    k1 = kernels.cholesky_inverse_cuda
    plain = supernodal.chol_inverse

    def counted(D):
        k1.launches += 1
        return plain(D)

    monkeypatch.setattr(supernodal, "chol_inverse", counted)
    monkeypatch.setattr(torch.profiler, "profile", _Profile)
    seen = []
    real = attribution.profile

    def recording(fn, device, **kw):
        def call():
            seen.append("call")
            return fn()
        seen.append(("profile", device, kw.get("agree")))
        return real(call, device, **kw)

    monkeypatch.setattr(attribution, "profile", recording)
    recs = {}
    for profile in (False, True):
        group = _OneRank(0, 1, _CPU, "gloo")
        ex = DistExecutor(plan, group, "float32", "cpu")
        recs[profile] = {}
        runs._first_factorize(group, recs[profile], ex, data, profile)
    assert seen == [("profile", _CPU, None), "call", "call"]
    one, prof = recs[False], recs[True]
    assert (prof["k1_launches"] == one["k1_launches"]
            == ex.chol_calls_per_factorize > 0)
    assert prof["psum_calls"] == one["psum_calls"] > 0
    assert prof["psum_bytes"] == one["psum_bytes"] > 0
    assert prof["profiles_taken"] == 1 and prof["host_busy_ms"] is None
    assert "device_busy_ms" not in prof
    assert prof["k1_checks"] == one["k1_checks"]


def test_profile_retries_as_the_group_agrees(monkeypatch):
    """``attribution.profile`` keeps a profile only where ``agree`` says
    every process would: a group that never agrees takes three, and calls
    ``fn`` once more before them, the same count on every rank."""
    monkeypatch.setattr(torch.profiler, "profile", _Profile)
    calls, verdicts = [], []

    def agree(ok):
        verdicts.append(ok)
        return False

    _, _, tries = attribution.profile(lambda: calls.append(1), _CPU,
                                      agree=agree)
    assert tries == 3 and len(calls) == 4 and verdicts == [True] * 3
    _, _, tries = attribution.profile(lambda: calls.append(1), _CPU,
                                      agree=lambda ok: ok)
    assert tries == 1 and len(calls) == 6
