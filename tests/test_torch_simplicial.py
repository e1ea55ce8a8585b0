"""The port's simplicial tier against the JAX package's, on the CPU.

The same matrices (``generate.SUITE``) and right-hand sides (a numpy seed)
go through ``parsy_bench_tpu`` and ``parsy_bench_tpu_torch``: the copied
``symbolic/plan.py`` gives equal plans, and ``SimplicialExecutor``'s
factorize and its three solves agree within 1e-10 in f64 and 1e-5 of the
values' scale in f32 (the sums of ``index_add_`` may run in another
order).  One JAX compile per configuration.
"""
import numpy as np
import pytest
import scipy.sparse as sp

import jax

# as in every test file that shares a worker with JAX f64 tests
jax.config.update("jax_enable_x64", True)

import torch

from parsy_bench_tpu.config import SolverConfig
from parsy_bench_tpu.core import generate
from parsy_bench_tpu.core.csc import CSC
from parsy_bench_tpu.models import CholeskySolver as JaxCholeskySolver
from parsy_bench_tpu.symbolic import plan as jplan
from parsy_bench_tpu_torch import CholeskySolver, NotPositiveDefiniteError
from parsy_bench_tpu_torch import SolverConfig as PortConfig
from parsy_bench_tpu_torch.core import generate as port_generate
from parsy_bench_tpu_torch.core.csc import CSC as PortCSC
from parsy_bench_tpu_torch.ops.simplicial import SimplicialExecutor
from parsy_bench_tpu_torch.symbolic import plan as pplan
from test_torch_native import reload_native_libs
from test_torch_supernodal import _assert_same

# a test process that lost a native library's first-build race loads it
# now, so both packages' inspectors run native
reload_native_libs()

torch.set_num_threads(1)

#: bars of the comparison with JAX: f64 absolute, f32 relative to scale
TOL = {"float64": 1e-10, "float32": 1e-5}


def _solvers(name, dtype):
    cfg = dict(tier="simplicial", ordering="amd", dtype=dtype)
    js = JaxCholeskySolver(generate.SUITE[name](), SolverConfig(**cfg))
    ps = CholeskySolver(port_generate.SUITE[name](), PortConfig(**cfg),
                        device="cpu")
    return js, ps


@pytest.mark.parametrize("name", ["tiny", "bcsstk14ish", "ecology_small"])
def test_plan_matches_jax(name):
    """Each package's own inspector emits the same simplicial plan (the
    update triples included), and the DAG levels and trisolve plan of its
    factor pattern agree."""
    js, ps = _solvers(name, "float64")
    assert np.array_equal(js.perm, ps.perm)
    _assert_same(js.plan, ps.plan, "plan")
    lpat = ps.lpat
    assert np.array_equal(jplan.dag_levels(js.lpat), pplan.dag_levels(lpat))
    ones = np.ones(lpat.nnz)
    jlev, jp = jplan.trisolve_plan(CSC(lpat.shape[0], lpat.indptr,
                                       lpat.indices, ones))
    plev, pp = pplan.trisolve_plan(PortCSC(lpat.shape[0], lpat.indptr,
                                           lpat.indices, ones))
    assert np.array_equal(jlev, plev)
    _assert_same(jp, pp, "trisolve_plan")


@pytest.mark.parametrize("name,dtype", [("tiny", "float64"),
                                        ("bcsstk14ish", "float64"),
                                        ("bcsstk14ish", "float32")])
def test_factorize_and_solves_match_jax(name, dtype):
    """CholeskySolver(tier="simplicial") and its executor's solve_lower,
    solve_upper and solve_spd on a seeded right-hand side."""
    js, ps = _solvers(name, dtype)
    js.factorize()
    ps.factorize()
    jl = np.asarray(js.lx, dtype=np.float64)
    pl = ps.lx.numpy().astype(np.float64)
    scale = np.abs(jl).max()
    tol = TOL[dtype] * (scale if dtype == "float32" else 1.0)
    assert np.max(np.abs(pl - jl)) <= tol
    b = np.random.default_rng(3).standard_normal(ps.a.n)
    for fn in ("solve_lower", "solve_upper", "solve_spd"):
        xj = np.asarray(getattr(js.executor, fn)(js.lx, b), np.float64)
        xp = getattr(ps.executor, fn)(ps.lx, b).numpy().astype(np.float64)
        bar = TOL[dtype] * (np.abs(xj).max() if dtype == "float32" else 1)
        assert np.max(np.abs(xp - xj)) <= bar, fn
    bar = 1e-10 if dtype == "float64" else 1e-3
    assert ps.factor_residual() < bar
    a = ps.a
    assert ps.solve_residual(a.spd_rhs_for_ones(),
                             ps.solve(a.spd_rhs_for_ones())) < bar
    dense = ps.ap.symmetrize_from_lower().to_dense()
    if dtype == "float64":
        assert np.max(np.abs(ps.factor_csc().to_dense()
                             - np.linalg.cholesky(dense))) < 1e-10


def test_programs_and_aliasing():
    """Each entry point runs one program; results are clones that a later
    call leaves alone; wrong lengths raise."""
    a = port_generate.SUITE["tiny"]()
    s = CholeskySolver(a, PortConfig(tier="simplicial", dtype="float64"),
                       device="cpu")
    ex = s.executor
    assert isinstance(ex, SimplicialExecutor)
    assert ex.nsteps == s.plan.nlev and ex.num_segments >= 1
    assert ex.table_bytes > 0
    lx1 = ex.factorize(s.ap.data)
    keep = lx1.clone()
    lx2 = ex.factorize(2 * s.ap.data)
    assert torch.equal(lx1, keep)
    assert torch.allclose(lx2, lx1 * np.sqrt(2), rtol=1e-12, atol=0)
    b = a.spd_rhs_for_ones()[s.perm]
    x1 = ex.solve_spd(lx1, b)
    x2 = ex.solve_spd(lx2, b)
    assert torch.allclose(x2, x1 / 2, rtol=1e-12, atol=1e-14)
    assert set(ex.programs) == {"factorize", "solve_spd"}
    assert ex.programs["factorize"].launches is not None
    with pytest.raises(ValueError, match="A values"):
        ex.factorize(s.ap.data[:-1])
    with pytest.raises(ValueError, match="vector"):
        ex.solve_lower(lx1, b[:-1])
    with pytest.raises(ValueError, match="shapes"):
        ex.solve_lower(lx1[:-1], b)
    with pytest.raises(ValueError, match="fused_finalize"):
        CholeskySolver(a, PortConfig(tier="simplicial"), device="cpu",
                       fused_finalize=True)


def test_indefinite_matrix_raises():
    a = port_generate.SUITE["bcsstk14ish"]()
    m = a.symmetrize_from_lower().to_scipy().tolil()
    m[50, 50] = -abs(m[50, 50]) - 1.0
    bad = PortCSC.from_scipy(sp.tril(m.tocsc(), 0).tocsc())
    s = CholeskySolver(bad, PortConfig(tier="simplicial", dtype="float64"),
                       device="cpu")
    with pytest.raises(NotPositiveDefiniteError):
        s.factorize()
    assert not s.factor_ok()
