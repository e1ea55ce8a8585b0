"""The port's drivers (``parsy_bench_tpu_torch/cli.py``) on the CPU: each
subcommand prints the JSON keys of the JAX package's driver on the same
arguments, verified where the driver verifies, and ``--device`` defaults
to the card."""
import contextlib
import io as _stdio
import json

import numpy as np
import pytest
import scipy.io as sio
import scipy.sparse as sp

import jax

# as in every test file that shares a worker with JAX f64 tests
jax.config.update("jax_enable_x64", True)

import torch

from parsy_bench_tpu.cli import main as jax_main
from parsy_bench_tpu_torch.cli import main
from test_torch_native import reload_native_libs

# a test process that lost a native library's first-build race loads it
# now, so both packages' inspectors run native
reload_native_libs()

torch.set_num_threads(1)


def _run(fn, argv) -> dict:
    buf = _stdio.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    (out,) = [json.loads(s) for s in buf.getvalue().splitlines()
              if s.startswith("{")]
    return out


def _both(argv):
    """(JAX driver's line, port driver's line on the CPU)."""
    jout = _run(jax_main, argv)
    pout = _run(main, argv + ["--device", "cpu"])
    assert set(jout) <= set(pout), set(jout) - set(pout)
    return jout, pout


@pytest.mark.parametrize("tier", ["supernodal", "simplicial"])
def test_cholesky_driver(tier):
    """With ``--profile`` the supernodal line carries the model's summary
    under the JAX driver's keys."""
    jout, pout = _both(["cholesky", "gen:laplace3d:5", "--tier", tier,
                        "--iters", "2", "--verify", "--profile"])
    assert pout["device"] == "cpu" and pout["n"] == jout["n"] == 125
    assert pout["factor_residual"] < 1e-3 and pout["solve_residual"] < 1e-3
    if tier == "supernodal":
        assert pout["update_delta"] == "gather"
        for k in ("nlev", "nsuper", "table_mb", "pool_mb"):
            assert pout[k] == jout[k], k
        assert set(pout["model"]) == set(jout["model"])
        assert pout["model"]["sequential_steps"] == jout["model"][
            "sequential_steps"]
    else:
        assert "model" not in pout and "model" not in jout


def test_trisolve_driver_on_a_factor():
    jout, pout = _both(["trisolve", "gen:laplace3d:5", "--iters", "2"])
    assert pout["verified"] and jout["verified"]
    for k in ("n", "nnz_l", "nlev", "schedule", "steps"):
        assert pout[k] == jout[k], k


@pytest.mark.parametrize("sched", ["wavefront", "coarsened"])
def test_trisolve_driver_lower_nonchordal(tmp_path, sched):
    """A general non-chordal lower-triangular L read from a file
    (``--lower``; reference triangularTest_DAG_nonChordal.cpp)."""
    n = 40
    m = sp.random(n, n, density=0.08, random_state=1, format="csc")
    path = tmp_path / "l.mtx"
    sio.mmwrite(str(path), (sp.tril(m, -1) + sp.eye(n)).tocoo())
    jout, pout = _both(["trisolve", str(path), "--lower", "--tier",
                        "simplicial", "--schedule", sched, "--iters", "1"])
    assert pout["verified"] and pout["schedule"] == jout["schedule"] == sched
    assert pout["steps"] == jout["steps"] and pout["nlev"] == jout["nlev"]


def test_baseline_and_lowerhalf_drivers(tmp_path):
    (jb, pb) = (_run(jax_main, ["baseline", "gen:laplace2d:8", "--iters",
                                "1"]),
                _run(main, ["baseline", "gen:laplace2d:8", "--iters", "1"]))
    assert set(jb) == set(pb)
    assert pb["splu_residual"] < 1e-10 and pb["trsv_verified"]
    full = tmp_path / "full.mtx"
    a = sp.random(12, 12, density=0.3, random_state=0)
    a = (a + a.T + 12 * sp.eye(12)).tocoo()
    sio.mmwrite(str(full), a)
    outs = [_run(fn, ["lowerhalf", str(full), str(tmp_path / f"{k}.mtx")])
            for k, fn in (("jax", jax_main), ("port", main))]
    assert set(outs[0]) == set(outs[1]) and outs[1]["n"] == 12
    low = tmp_path / "port.mtx"
    assert sio.mminfo(str(low))[5] == "symmetric"
    assert abs(sio.mmread(str(low)).tocsc() - a.tocsc()).max() < 1e-12
    assert open(low).read() == open(tmp_path / "jax.mtx").read()


def test_ordering_file_and_refusals(tmp_path, monkeypatch):
    from parsy_bench_tpu_torch.core.io import read_ordering, write_ordering
    perm = np.random.default_rng(0).permutation(16)
    path = tmp_path / "perm.txt"
    write_ordering(str(path), perm)
    assert np.array_equal(read_ordering(str(path), 16), perm)
    out = _run(main, ["cholesky", "gen:laplace2d:4", "--tier", "simplicial",
                      "--ordering-file", str(path), "--iters", "1",
                      "--verify", "--device", "cpu"])
    assert out["factor_residual"] < 1e-3
    # --profile is ported: cholesky adds the model's summary, trisolve
    # accepts it and prints what it prints without it
    out = _run(main, ["cholesky", "gen:laplace2d:4", "--profile", "--iters",
                      "1", "--device", "cpu"])
    assert out["model"]["model_s"] > 0
    args = ["trisolve", "gen:laplace2d:4", "--iters", "1", "--device", "cpu"]
    assert set(_run(main, args + ["--profile"])) == set(_run(main, args))
    # without --device the numeric phase asks for the card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["trisolve", "gen:laplace2d:4"])
