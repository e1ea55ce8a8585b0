"""The port's pair-granular forward solve against the JAX package (CPU,
small).

* ``solve_lower`` (fast: ``solve_prep`` then the slot-window solve)
  against the JAX executor's ``solve_lower`` (fast there too) and against
  the port's own leveled solve, on every case of
  tests/test_torch_supernodal.py.  Bars: f64 1e-10; f32 1e-3 of the
  largest |x|;
* the ``solve_prep`` cache is rebuilt for new pools and for pools changed
  in place;
* a plan whose slot tables would be clamped by JAX raises when the
  executor is built;
* plans with a dense top (a partial one and one that absorbs every
  segment) with the aligned-operand pool off, on and over its budget:
  the pool's bytes and switch, ``top_inverse``, every tensor of
  ``solve_prep``'s (tinv, linv, gp) triple, ``solve_lower`` and
  ``solve_loop`` against the JAX executor's (f64 1e-10; f32 1e-4 of the
  scale), and the triple rebuilt for pools changed in place.
"""
import copy
import dataclasses

import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import torch

from parsy_bench_tpu.config import SolverConfig
from parsy_bench_tpu.core import generate
from parsy_bench_tpu.core.csc import CSC
from parsy_bench_tpu.models import CholeskySolver as JaxCholeskySolver
from parsy_bench_tpu.ops.supernodal import (
    SupernodalExecutor as JaxSupernodalExecutor)
from parsy_bench_tpu_torch import CholeskySolver
from parsy_bench_tpu_torch.ops.supernodal import SupernodalExecutor
from test_torch_native import reload_native_libs

# a test process that lost a native library's first-build race
# loads it now, so both packages' inspectors run native
reload_native_libs()

# one intra-op thread per test process: the suite runs several pytest
# workers at once, and torch's default pool (one thread per core) in each
# of them oversubscribes the cores many times over on these small ops
torch.set_num_threads(1)

#: the cases of tests/test_torch_supernodal.py: name -> (matrix factory,
#: SolverConfig overrides)
CASES = {
    "tiny_amd": (lambda: generate.SUITE["tiny"](), dict(ordering="amd")),
    "tiny_amd_scatter": (lambda: generate.SUITE["tiny"](),
                         dict(ordering="amd", update_delta="scatter")),
    "bcsstk14ish_amd": (lambda: generate.SUITE["bcsstk14ish"](),
                        dict(ordering="amd")),
    "laplace3d8_nd": (lambda: generate.laplace_3d(8), dict(ordering="nd")),
    "laplace3d8_nd_scatter": (lambda: generate.laplace_3d(8),
                              dict(ordering="nd", update_delta="scatter")),
    "laplace2d16_amd_split": (lambda: generate.laplace_2d(16),
                              dict(ordering="amd", fin_bucket_elems=4096)),
}


def _config(case, dtype="float64", **kw):
    return SolverConfig(tier="supernodal", dtype=dtype, **CASES[case][1],
                        **kw)


@pytest.mark.parametrize("case,dtype", [(c, "float64") for c in CASES]
                         + [("laplace3d8_nd", "float32")])
def test_fast_solve_lower_matches_jax(case, dtype):
    a = CASES[case][0]()
    cfg = _config(case, dtype)
    port = CholeskySolver(a, cfg, device="cpu").factorize()
    ex = port.executor
    assert ex._has_fast_solve
    ref = JaxCholeskySolver(a, cfg).factorize()
    assert ref.executor._has_fast_solve
    b = np.random.default_rng(5).standard_normal(a.n)
    xj = np.asarray(ref.executor.solve_lower(ref.lx, b))
    x = ex.solve_lower(port.lx, b).numpy()
    xl = ex._solve_lower_impl(port.lx, ex._vec(b)).numpy()
    bar = 1e-10 if dtype == "float64" else 1e-3 * max(1.0, np.abs(xj).max())
    assert np.max(np.abs(x - xj)) <= bar
    assert np.max(np.abs(x - xl)) <= bar
    if dtype == "float64":
        # and it is the forward solve: L x = b
        lmat = port.factor_csc().to_scipy()
        assert np.max(np.abs(lmat @ x - b)) <= 1e-10 * max(1.0,
                                                           np.abs(b).max())


def test_solve_prep_cache_follows_the_pools():
    a = generate.SUITE["tiny"]()
    s = CholeskySolver(a, _config("tiny_amd"), device="cpu").factorize()
    ex = s.executor
    b = np.random.default_rng(6).standard_normal(a.n)
    linv = ex.solve_prep(s.lx)[1]
    assert ex.solve_prep(s.lx)[1] is linv
    x1 = ex.solve_lower(s.lx, b).numpy()
    # new values on the same pattern: new pools, a new Linv pool
    s.factorize(CSC(a.n, a.indptr, a.indices, a.data * 4.0))
    linv2 = ex.solve_prep(s.lx)[1]
    assert linv2 is not linv
    assert np.max(np.abs(ex.solve_lower(s.lx, b).numpy() - x1 / 2.0)) \
        <= 1e-12
    # the same pools changed in place: rebuilt as well, so the fast solve
    # reads the inverses now stored in the pools, as the leveled one does
    for p in s.lx:
        p.mul_(2.0)
    linv3 = ex.solve_prep(s.lx)[1]
    assert linv3 is not linv2
    x3 = ex.solve_lower(s.lx, b).numpy()
    assert np.max(np.abs(x3 - x1 / 2.0)) > 1e-3
    assert np.max(np.abs(
        x3 - ex._solve_lower_impl(s.lx, ex._vec(b)).numpy())) <= 1e-12


def _corrupt(plan, what):
    plan = copy.deepcopy(plan)
    seg = next(s for s in plan.segments if s.supd)
    if what == "srlo":
        seg.srlo = seg.srlo.copy()
        seg.srlo[0, -1] = int(plan.npanels[0])
    elif what == "xrow":
        seg.supd[0].xrow = seg.supd[0].xrow.copy()
        seg.supd[0].xrow[0, 0] = int(plan.npanels[seg.supd[0].kcls])
    else:
        seg.supd[0].dst = seg.supd[0].dst.copy()
        seg.supd[0].dst[0, 0] = seg.sslice[seg.supd[0].ccls] + 1
    return plan


@pytest.mark.parametrize("what", ["srlo", "xrow", "dst"])
def test_corrupt_solve_tables_raise(what):
    s = CholeskySolver(generate.laplace_3d(8), _config("laplace3d8_nd"),
                       device="cpu")
    with pytest.raises(ValueError, match="plan out of bounds"):
        SupernodalExecutor(_corrupt(s.plan, what), "float64", "cpu")


def test_unported_solve_features_raise():
    """The two plans this test once saw refused, a dense top and the
    aligned-operand pool, now build and solve: the fast forward solve
    equals the leveled one (f64)."""
    a = generate.laplace_3d(8)
    b = np.random.default_rng(7).standard_normal(a.n)
    for kw in (dict(dense_top_cols=10**6, dense_top_thin=1000),
               dict(solve_gpool_mb=64)):
        s = CholeskySolver(a, _config("laplace3d8_nd", **kw),
                           device="cpu").factorize()
        ex = s.executor
        assert (ex._top is not None) == ("dense_top_cols" in kw)
        assert ex._gpool_enabled
        x = ex.solve_lower(s.lx, b).numpy()
        xl = ex._solve_lower_impl(s.lx, ex._vec(b)).numpy()
        assert np.max(np.abs(x - xl)) <= 1e-10 * max(1.0, np.abs(xl).max())


#: dense-top plans: name -> (matrix factory, SolverConfig overrides).  The
#: partial top keeps one of five segments in the level steps (t = 459 > 256,
#: so ``dense_tri_inv`` splits); the whole top absorbs every segment
TOP_CASES = {
    "partial_top": (lambda: generate.SUITE["bcsstk14ish"](),
                    dict(ordering="amd", dense_top_cols=512)),
    "whole_top": (lambda: generate.laplace_3d(8),
                  dict(ordering="nd", dense_top_cols=10**6,
                       dense_top_thin=1000)),
}


def _triple_err(port, ref):
    """Largest |port - JAX| over a ``solve_prep`` triple, checking that
    both hold the same tensors: Tinv, the Linv pools and the slabs."""
    (tp, lp, gp), (tj, lj, gj) = port, ref
    pairs = [(tp, tj)] + list(zip(lp, lj))
    assert len(lp) == len(lj) and len(gp) == len(gj) == 2
    assert len(gp[0]) == len(gj[0]) and len(gp[1]) == len(gj[1])
    for sp, sj in zip(gp[0], gj[0]):
        assert len(sp) == len(sj)
        pairs += list(zip(sp, sj))
    pairs += list(zip(gp[1], gj[1]))
    err = 0.0
    for p, j in pairs:
        j = np.asarray(j)
        assert tuple(p.shape) == j.shape
        if j.size:
            err = max(err, float(np.max(np.abs(p.numpy() - j))))
    return err


@pytest.mark.parametrize("case,dtype", [("partial_top", "float64"),
                                        ("whole_top", "float64"),
                                        ("partial_top", "float32")])
def test_dense_top_and_gpool_match_jax(case, dtype):
    """A dense-top plan with the aligned-operand pool off (budget 0), on
    and over its budget (1 MB; f32: on only), on one factor per package:
    the pool's bytes and switch, ``top_inverse`` and every tensor of
    ``solve_prep``'s triple equal the JAX executor's, and so do
    ``solve_lower`` and ``solve_loop`` (f64 1e-10; f32 1e-4 of the largest
    |entry|; the JAX ``solve_loop`` once, on the partial top with the pool
    on), which also equal the leveled solve's x (the top's updates counted
    once).  The plans differ only on the solve side, so each factor serves
    every variant of its package."""
    a = TOP_CASES[case][0]()
    cfg = SolverConfig(tier="supernodal", dtype=dtype, **TOP_CASES[case][1])
    port = CholeskySolver(a, cfg, device="cpu").factorize()
    ref = JaxCholeskySolver(a, cfg).factorize()
    top = port.plan.top
    assert top is not None and top.t == ref.plan.top.t
    assert port.plan.solve_nseg == ref.plan.solve_nseg
    nseg = len(port.plan.segments)
    assert (0 < port.plan.solve_nseg < nseg if case == "partial_top"
            else port.plan.solve_nseg == 0)
    b = np.random.default_rng(8).standard_normal(a.n)
    tol = 1e-10 if dtype == "float64" else 1e-4
    seen = set()
    for mb in ((0, 64, 1) if dtype == "float64" else (64,)):
        ex = SupernodalExecutor(dataclasses.replace(port.plan, gpool_mb=mb),
                                dtype, "cpu")
        jx = JaxSupernodalExecutor(dataclasses.replace(ref.plan, gpool_mb=mb),
                                   dtype=dtype)
        assert ex._gpool_bytes == jx._gpool_bytes
        assert ex._gpool_enabled == jx._gpool_enabled
        seen.add(ex._gpool_enabled)
        tinv = ex.top_inverse(port.lx)
        tj = np.asarray(jx.top_inverse(ref.lx))
        assert tinv.shape == (top.t, top.t)
        scale = max(1.0, np.abs(tj).max()) if dtype == "float32" else 1.0
        assert np.max(np.abs(tinv.numpy() - tj)) <= tol * scale
        trip = ex.solve_prep(port.lx)
        assert ex.top_inverse(port.lx) is tinv
        assert _triple_err(trip, jx.solve_prep(ref.lx)) <= tol * scale
        xj = np.asarray(jx.solve_lower(ref.lx, b))
        bar = tol * max(1.0, np.abs(xj).max())
        x = ex.solve_lower(port.lx, b).numpy()
        assert np.max(np.abs(x - xj)) <= bar
        assert np.max(np.abs(ex.solve_loop(port.lx, b, 3).numpy() - xj)) \
            <= bar
        if (case, dtype, mb) == ("partial_top", "float64", 64):
            assert np.max(np.abs(np.asarray(jx.solve_loop(ref.lx, b, 2))
                                 - xj)) <= bar
        xl = ex._solve_lower_impl(port.lx, ex._vec(b)).numpy()
        assert np.max(np.abs(x - xl)) <= bar
    # whole top: no pairs below the top, so even a 0 MB budget holds the
    # (empty) pool, as in JAX
    assert seen == ({True} if case == "whole_top" or dtype == "float32"
                    else {True, False})


def test_dense_top_triple_follows_the_pools():
    """With a dense top and the pool on, ``solve_prep``'s triple is
    rebuilt for pools changed in place, and each factor keeps its own."""
    a, kw = TOP_CASES["partial_top"]
    a = a()
    cfg = SolverConfig(tier="supernodal", dtype="float64", solve_gpool_mb=64,
                       **kw)
    s = CholeskySolver(a, cfg, device="cpu").factorize()
    ex = s.executor
    assert ex._top is not None and ex._gpool_enabled
    b = np.random.default_rng(9).standard_normal(a.n)
    t1 = ex.solve_prep(s.lx)
    keep = [x.clone() for x in ex._prep_flat(t1)]
    x1 = ex.solve_lower(s.lx, b).numpy()
    lx2 = tuple(p.clone() for p in s.lx)
    for p in lx2:
        p.mul_(2.0)
    t2 = ex.solve_prep(lx2)
    assert t2 is not t1
    assert all(torch.equal(x, y) for x, y in zip(ex._prep_flat(t1), keep))
    for p in s.lx:
        p.mul_(2.0)
    t3 = ex.solve_prep(s.lx)
    assert t3 is not t1
    assert all(torch.equal(x, y) for x, y in zip(ex._prep_flat(t3),
                                                  ex._prep_flat(t2)))
    # the pools changed in place hold lx2's values: the same x
    x3 = ex.solve_lower(s.lx, b).numpy()
    assert np.array_equal(x3, ex.solve_lower(lx2, b).numpy())
    assert np.max(np.abs(x3 - x1)) > 1e-3
