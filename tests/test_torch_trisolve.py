"""The port's triangular-solve workload against the JAX package's, on the
CPU: the copied ``plan``, ``reach``, ``strisolve`` and ``dagplan`` modules
give equal arrays, and ``TriangularSolver`` at both tiers and both
schedules gives the JAX package's ``solve`` and ``solve_transposed`` within
1e-10 in f64, on a chordal L (a factor) and a non-chordal one (the lower
half of A); ``prepare_solve_pools`` gives JAX's pools; both pruned solvers
give the full solve.  Inputs are ``generate.SUITE`` matrices and numpy
seeds; one JAX compile per configuration.
"""
import importlib

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
from parsy_bench_tpu.models import TriangularSolver as JaxTriangularSolver
from parsy_bench_tpu.symbolic import dagplan as jdag
from parsy_bench_tpu.symbolic import plan as jplan
from parsy_bench_tpu.symbolic import strisolve as jstri
from parsy_bench_tpu_torch import CholeskySolver
from parsy_bench_tpu_torch import SolverConfig as PortConfig
from parsy_bench_tpu_torch import TriangularSolver
from parsy_bench_tpu_torch.core import generate as port_generate
from parsy_bench_tpu_torch.core.csc import CSC as PortCSC
from parsy_bench_tpu_torch.core.csc import check_triangular
from parsy_bench_tpu_torch.symbolic import dagplan as pdag
from parsy_bench_tpu_torch.symbolic import plan as pplan
from parsy_bench_tpu_torch.symbolic import reach as preach
from parsy_bench_tpu_torch.symbolic import strisolve as pstri
from test_torch_native import reload_native_libs
from test_torch_supernodal import _assert_same

# the JAX package's symbolic/__init__ re-exports a function under the
# module name ``reach``
jreach = importlib.import_module("parsy_bench_tpu.symbolic.reach")

# a test process that lost a native library's first-build race loads it
# now, so both packages' inspectors run native
reload_native_libs()

torch.set_num_threads(1)

#: right-hand-side rows of the pruned solves, per case
RHS_ROWS = {"chordal": [5, 300, 500], "nonchordal": [7, 900, 1500]}


def _lower(case):
    """scipy CSC L: the factor of ``bcsstk14ish`` under AMD (chordal; the
    port's simplicial tier, f64), or the lower half of ``apache_small``
    (non-chordal)."""
    if case == "chordal":
        s = CholeskySolver(port_generate.SUITE["bcsstk14ish"](),
                           PortConfig(tier="simplicial", dtype="float64"),
                           device="cpu").factorize()
        m = s.factor_csc().to_scipy().tocsc()
    else:
        m = generate.SUITE["apache_small"]().to_scipy().tocsc()
    m.sort_indices()
    return m


def _pair(case):
    m = _lower(case)
    return CSC.from_scipy(m), PortCSC.from_scipy(m)


def _pattern(m):
    return sp.csc_matrix((np.ones(m.nnz, dtype=np.int8), m.indices,
                          m.indptr), shape=m.shape)


@pytest.mark.parametrize("case", ["chordal", "nonchordal"])
def test_plans_match_jax(case):
    """dag_levels, the wavefront plan, the coarse plan, the blocked
    trisolve plan, reach, reach_sn and cc_partition."""
    jl, pl = _pair(case)
    lpat = _pattern(jl.to_scipy())
    lev = jplan.dag_levels(lpat)
    assert np.array_equal(lev, pplan.dag_levels(lpat))
    _assert_same(jplan.plan_from_pattern(lpat, lev, with_updates=False),
                 pplan.plan_from_pattern(lpat, lev, with_updates=False),
                 "plan")
    for w in (64, 256):
        _assert_same(jdag.build_coarse_trisolve(jl, lev, w),
                     pdag.build_coarse_trisolve(pl, lev, w), f"coarse{w}")
    nlev = int(lev.max()) + 1
    for t0, t1 in ((0, nlev), (1, max(2, nlev // 2))):
        assert np.array_equal(jdag.cc_partition(lpat, lev, t0, t1),
                              pdag.cc_partition(lpat, lev, t0, t1))
    jp = jstri.build_trisolve_plan(jl, SolverConfig())
    pp = pstri.build_trisolve_plan(pl, PortConfig())
    _assert_same(jp, pp, "trisolve_plan")
    rows = np.array(RHS_ROWS[case])
    assert np.array_equal(jreach.reach(lpat, rows), preach.reach(lpat, rows))
    lay, part = pp.layout, pp.layout.part
    assert np.array_equal(
        jreach.reach_sn(lay.rptr, lay.rows, part.sptr, part.col2sup, rows),
        preach.reach_sn(lay.rptr, lay.rows, part.sptr, part.col2sup, rows))


def test_ereach_matches_jax():
    a = generate.SUITE["bcsstk14ish"]()
    from parsy_bench_tpu.symbolic.etree import etree
    parent = etree(a)
    upper = a.to_scipy().T.tocsc()
    pa = PortCSC(a.n, a.indptr, a.indices, a.data)
    for k in (0, 17, 300, a.n - 1):
        assert np.array_equal(jreach.ereach(a, parent, k, upper=upper),
                              preach.ereach(pa, parent, k))


def _bt(m):
    """b = L^T 1, so that the transposed solve gives ones."""
    return np.asarray(m.T @ np.ones(m.shape[0]))


@pytest.mark.parametrize("case,sched", [("chordal", "wavefront"),
                                        ("chordal", "coarsened"),
                                        ("nonchordal", "wavefront"),
                                        ("nonchordal", "coarsened")])
def test_simplicial_tier_matches_jax(case, sched):
    jl, pl = _pair(case)
    cfg = dict(tier="simplicial", dtype="float64", trisolve_schedule=sched,
               coarse_width=128)
    jt = JaxTriangularSolver(jl, SolverConfig(**cfg))
    pt = TriangularSolver(pl, PortConfig(**cfg), device="cpu")
    assert pt.schedule == jt.schedule == sched
    assert pt.nlev == jt.nlev
    rng = np.random.default_rng(11)
    for b in (pl.to_scipy() @ np.ones(pl.n), rng.standard_normal(pl.n)):
        assert np.max(np.abs(pt.solve(b) - np.asarray(jt.solve(b)))) < 1e-10
        assert np.max(np.abs(pt.solve_transposed(b)
                             - np.asarray(jt.solve_transposed(b)))) < 1e-10
    assert check_triangular(pt.solve(pl.to_scipy() @ np.ones(pl.n)))
    assert np.max(np.abs(pt.solve_transposed(_bt(pl.to_scipy())) - 1)) < 1e-8


@pytest.mark.parametrize("case", ["chordal", "nonchordal"])
def test_supernodal_tier_matches_jax(case):
    """The blocked TriangularSolver: the pools after init_pools and
    prepare_solve_pools equal JAX's (1e-12 of their scale: the Neumann
    products run through another BLAS), and both solves agree."""
    jl, pl = _pair(case)
    cfg = dict(tier="supernodal", dtype="float64")
    jt = JaxTriangularSolver(jl, SolverConfig(**cfg))
    pt = TriangularSolver(pl, PortConfig(**cfg), device="cpu")
    assert pt.nlev == jt.nlev
    for jp, pp in zip(jt._lx, pt._lx):
        jp = np.asarray(jp)
        assert jp.shape == tuple(pp.shape)
        assert np.max(np.abs(pp.numpy() - jp)) <= 1e-12 * np.abs(jp).max()
    # the lower triangles keep L's values: only Linv^T was added above
    raw = pt.executor.init_pools(pl.data)
    ex = pt.executor
    for seg, tabs in zip(ex.plan.segments, ex._segs):
        for t in range(seg.nsteps):
            for b, ft in zip(seg.fin, tabs.fin):
                k = int(ft.cnt[t])      # the step's real lanes
                got = ex._panel_blk(pt._lx, b, ft, tabs.rlo, t)[:k]
                want = ex._panel_blk(raw, b, ft, tabs.rlo, t)[:k]
                assert torch.equal(torch.tril(got[:, :b.c, :]),
                                   torch.tril(want[:, :b.c, :]))
                assert torch.equal(got[:, b.c:, :], want[:, b.c:, :])
    b = np.random.default_rng(5).standard_normal(pl.n)
    assert np.max(np.abs(pt.solve(b) - np.asarray(jt.solve(b)))) < 1e-10
    assert np.max(np.abs(pt.solve_transposed(b)
                         - np.asarray(jt.solve_transposed(b)))) < 1e-10
    assert check_triangular(pt.solve(pl.to_scipy() @ np.ones(pl.n)))
    assert np.max(np.abs(pt.solve_transposed(_bt(pl.to_scipy())) - 1)) < 1e-8


@pytest.mark.parametrize("case", ["chordal", "nonchordal"])
@pytest.mark.parametrize("tier", ["simplicial", "supernodal"])
def test_pruned_solvers_match_the_full_solve(case, tier):
    """Both pruned solvers give the full solve (b nonzero on the RHS rows
    only) within 1e-12, touching only the reach."""
    _, pl = _pair(case)
    ts = TriangularSolver(pl, PortConfig(tier=tier, dtype="float64",
                                         trisolve_schedule="wavefront"),
                          device="cpu")
    rows = np.array(RHS_ROWS[case])
    ps = ts.pruned(rows)
    b = np.zeros(pl.n)
    b[rows] = np.random.default_rng(2).standard_normal(len(rows))
    full = ts.solve(b)
    touched = ps.cols if tier == "supernodal" else ps.reach
    assert len(touched) < pl.n
    assert np.all(full[np.setdiff1d(np.arange(pl.n), touched)] == 0)
    assert np.max(np.abs(ps.solve(b) - full)) < 1e-12


def _chain(n):
    d = np.full(n, 2.0)
    e = np.full(n - 1, -1.0)
    return sp.diags([d, e], [0, -1]).tocsc()


@pytest.mark.parametrize("case", ["chain", "random", "grid"])
def test_choose_schedule_matches_jax(case):
    """Both packages pick the same schedule for the chain and the random
    DAG of tests/test_dagsolve.py (the chain "coarsened"; the random one
    is 40 levels deep in that draw, and both pick what its cost model
    says) and for the lower half of ``apache_small`` (shallow:
    "wavefront"); the port's auto schedule follows the pick."""
    want = {"chain": "coarsened", "grid": "wavefront"}.get(case)
    if case == "chain":
        m = _chain(4096)
    elif case == "random":
        rng = np.random.default_rng(1)
        m = sp.random(400, 400, density=0.05, random_state=rng,
                      format="lil")
        m = sp.tril(m, -1).tolil()
        m.setdiag(np.full(400, 3.0))
        m = m.tocsc()
    else:
        m = _lower("nonchordal")
    m.sort_indices()
    lev = jplan.dag_levels(_pattern(m))
    assert (case == "chain") == (int(lev.max()) + 1 == m.shape[0])
    jl, pl = CSC.from_scipy(m), PortCSC.from_scipy(m)
    pick = jdag.choose_schedule(jl, lev)
    assert pick == (want or pick)
    assert pdag.choose_schedule(pl, lev) == pick
    ts = TriangularSolver(pl, PortConfig(dtype="float64"), device="cpu")
    assert ts.schedule == pick
    if case == "chain":
        assert ts.plan.nsteps * 16 <= pl.n
    assert check_triangular(ts.solve(pl.to_scipy() @ np.ones(pl.n)))


@pytest.mark.parametrize("tier,sched", [("simplicial", "wavefront"),
                                        ("simplicial", "coarsened"),
                                        ("supernodal", "auto")])
def test_float32_gates(tier, sched):
    """f32 solves of the chordal factor: |1 - x_i| < 1e-3 both ways."""
    _, pl = _pair("chordal")
    ts = TriangularSolver(pl, PortConfig(tier=tier, dtype="float32",
                                         trisolve_schedule=sched),
                          device="cpu")
    m = pl.to_scipy()
    assert ts.solve(m @ np.ones(pl.n)).dtype == np.float32
    assert check_triangular(ts.solve(m @ np.ones(pl.n)))
    assert check_triangular(ts.solve_transposed(_bt(m)))


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pl = _pair("nonchordal")
    for tier in ("simplicial", "supernodal"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TriangularSolver(pl, PortConfig(tier=tier))
    with pytest.raises(ValueError, match="trisolve_schedule"):
        TriangularSolver(pl, PortConfig(trisolve_schedule="levels"),
                         device="cpu")
