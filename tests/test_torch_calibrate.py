"""The port's calibration driver
(``parsy_bench_tpu_torch/scripts/calibrate.py``) against the JAX script
``scripts/calibrate.py``, on the CPU:

* the JAX script run with ``--quick`` under ``JAX_PLATFORMS=cpu`` and the
  port's ``--quick --device cpu``, both as a user runs them: the port
  prints the JAX script's keys and ``card``, every ceiling finite and
  above 0;
* each amortized body's checksum equals a numpy restatement of the JAX
  body (scripts/calibrate.py:67-127) at a reduced size, where the gather's
  second parity runs past the pool's last row group (JAX clamps it);
* the shapes, seed and indices are the JAX script's;
* ``beside`` sets a ceiling beside ``ChipModel``'s field only where the
  fit gave the field a cost;
* without CUDA and without ``--device cpu`` the driver exits non-zero and
  prints no document.

The three subprocesses start together when the first test that needs
them runs.
"""
import ast
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from parsy_bench_tpu_torch.scripts import calibrate
from parsy_bench_tpu_torch.utils.perfmodel import ChipModel

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_JAX_SCRIPT = os.path.join(_REPO, "scripts", "calibrate.py")
_PORT = [sys.executable, "-m", "parsy_bench_tpu_torch.scripts.calibrate"]
#: name -> command
_RUNS = {"jax": [sys.executable, _JAX_SCRIPT, "--quick"],
         "port": _PORT + ["--quick", "--device", "cpu"],
         "no_device": _PORT + ["--quick"]}


@pytest.fixture(scope="module")
def procs(tmp_path_factory):
    """The runs of ``_RUNS``, started together from directories outside
    the checkout: name -> (process, stdout, stderr)."""
    env = dict(os.environ, PYTHONPATH=_REPO, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    out = {}
    for name, cmd in _RUNS.items():
        cwd = tmp_path_factory.mktemp(f"calibrate_{name}")
        so, se = open(cwd / "stdout", "w+"), open(cwd / "stderr", "w+")
        out[name] = (subprocess.Popen(cmd, cwd=cwd, env=env, stdout=so,
                                      stderr=se, text=True), so, se)
    yield out
    for p, so, se in out.values():
        if p.poll() is None:
            p.kill()
            p.wait()
        so.close()
        se.close()


def _finish(procs, name, timeout=300):
    p, so, se = procs[name]
    rc = p.wait(timeout)
    so.seek(0)
    se.seek(0)
    return rc, so.read(), se.read()


def _document(procs, name) -> dict:
    rc, out, err = _finish(procs, name)
    assert rc == 0, err[-3000:]
    return json.loads(out)


# ------------------------------------------------------ numpy bodies
#: a reduced size: 1,024 rows of 16, 64 row groups, windows of 64 rows,
#: 10 repetitions (both parities, every window offset 0-7)
_ROWS, _C, _W, _REPS = 1 << 10, 16, 64, 10
_PRODUCTS = ((2, 8, 16, "mxu"), (5, 4, 16, "lane"))


def _idx():
    """The JAX script's indices at the reduced size, with the last row
    group added, whose second parity a JAX gather clamps."""
    return np.concatenate([calibrate.indices(_ROWS, 64), [_ROWS - 8]])


def _numpy_bodies(pool, idx):
    """The JAX bodies (scripts/calibrate.py:67-127) restated in numpy."""
    rows, c = pool.shape
    out = {}
    p8 = pool.reshape(-1, 8 * c).astype(np.float64)
    out["gather"] = sum(
        p8[np.minimum(idx // 8 + (i & 1), rows // 8 - 1)].sum()
        for i in range(_REPS))
    p = pool.astype(np.float64)
    for i in range(_REPS):
        np.add.at(p, idx + (i & 1), 1.0)
    out["scatter"] = p.sum()
    p = pool.astype(np.float64)
    for i in range(_REPS):
        p[i & 7:(i & 7) + _W] += 1.0
    out["stream"] = p.sum()
    for P, m, k, tag in _PRODUCTS:
        A = np.ones((P, m, k), np.float32)
        B = np.ones((P, calibrate.Q, k), np.float32)
        acc = np.float32(0)
        for _ in range(_REPS):
            acc = np.einsum("pmk,pqk->pmq", A + acc, B).sum() * np.float32(
                1e-30)
        out[tag] = float(acc)
    M = np.eye(calibrate.CHAIN_N, dtype=np.float32) * np.float32(4.0)
    for _ in range(calibrate.CHAIN_STEPS * _REPS):
        M = M * (np.float32(1) / np.sqrt(M[0, 0]))
    out["chain"] = float(M[0, 0])
    return out


@pytest.fixture(scope="module")
def checksums(procs):
    rng = np.random.default_rng(3)
    pool = rng.standard_normal((_ROWS, _C)).astype(np.float32)
    idx = _idx()
    progs = calibrate.programs(torch.device("cpu"), _REPS,
                               torch.as_tensor(pool), idx, w=_W,
                               products=_PRODUCTS)
    for run, _ in progs.values():
        run()
    return ({name: float(o) for name, (_, o) in progs.items()},
            _numpy_bodies(pool, idx))


@pytest.mark.parametrize("name", ["gather", "scatter", "stream", "mxu",
                                  "lane", "chain"])
def test_body_checksum_is_the_jax_bodys(checksums, name):
    """Each body's checksum equals the numpy restatement of its JAX body,
    within f32 summation error."""
    got, want = checksums
    assert got[name] == pytest.approx(want[name], rel=1e-5, abs=1e-3)


def test_gather_clamps_its_second_parity_as_jax():
    """The reduced indices reach the last row group, so the gather's
    second parity names a group past the pool, which JAX clamps."""
    assert (_idx() // 8 + 1).max() == _ROWS // 8


def test_shapes_and_seed_are_the_jax_scripts():
    """The sizes, product shapes and indices are the JAX script's
    constants (read with ``ast``) and seed."""
    with open(_JAX_SCRIPT) as f:
        src = f.read()
    consts = {}
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0],
                                                       (ast.Name, ast.Tuple)):
            try:    # constant expressions only: no names, no builtins
                val = eval(compile(ast.Expression(node.value), "<jax>",
                                   "eval"), {"__builtins__": {}})
            except Exception:
                continue
            tgt = node.targets[0]
            names = ([tgt.id] if isinstance(tgt, ast.Name)
                     else [e.id for e in tgt.elts])
            vals = [val] if len(names) == 1 else list(val)
            consts.update(zip(names, vals))
    assert (consts["rows"], consts["c"]) == (calibrate.ROWS, calibrate.C)
    assert consts["nidx"] == calibrate.NIDX and consts["W"] == calibrate.W
    assert "default_rng(0)" in src and "64 * reps" in src
    assert "(64, 256, 128, \"mxu\"), (4096, 16, 128, \"lane\")" in src
    assert calibrate.PRODUCTS == ((64, 256, 128, "mxu"),
                                  (4096, 16, 128, "lane"))
    idx = calibrate.indices()
    assert idx.shape == (calibrate.NIDX,) and (idx % 8 == 0).all()
    assert np.array_equal(idx, np.random.default_rng(0).integers(
        0, calibrate.ROWS // 8, calibrate.NIDX) * 8)


# -------------------------------------------------------- the drivers
def test_port_prints_the_jax_scripts_keys(procs):
    """``--quick --device cpu`` prints one JSON document with the JAX
    script's keys (its own ``--quick`` run under ``JAX_PLATFORMS=cpu``), in
    its order, then ``card``."""
    jax_doc = _document(procs, "jax")
    port = _document(procs, "port")
    assert tuple(jax_doc) == calibrate.KEYS
    assert tuple(port) == calibrate.KEYS + ("card",)
    assert port["backend"] == "cpu" and port["card"] == "cpu"


def test_every_ceiling_is_finite_and_positive(procs):
    port = _document(procs, "port")
    for key in calibrate.FIELDS:
        assert math.isfinite(port[key]) and port[key] > 0, key


def test_without_cuda_the_driver_raises(procs):
    """Without ``--device cpu`` it asks for the card: here it exits
    non-zero, names CUDA and prints no document."""
    rc, out, err = _finish(procs, "no_device")
    assert rc != 0 and "CUDA" in err and "{" not in out


def test_beside_the_model():
    """A ceiling stands beside its ``ChipModel`` field as measured /
    fitted; a field fitted at no cost (inf, 0) and the dispatch floor
    (no field) get no ratio."""
    chip = ChipModel()
    got = {k: 2.0 for k in calibrate.FIELDS}
    out = calibrate.beside(got, chip)
    assert out["gather_rows_per_s"] == dict(
        field="gather_rows", fitted=chip.gather_rows,
        ratio=2.0 / chip.gather_rows)
    assert out["dispatch_s"] == dict(field=None, fitted=None, ratio=None)
    for key, field in (("scatter_rows_per_s", "scatter_rows"),
                       ("lane_s", "lane_s"), ("chain_op_s", "chain_op_s")):
        if getattr(chip, field) in (0.0, float("inf")):
            assert out[key]["ratio"] is None and out[key]["fitted"] is None
