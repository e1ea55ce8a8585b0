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
  executor is built, and plans with parts not ported yet raise
  ``NotImplementedError``.
"""
import copy

import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import torch

from parsy_bench_tpu.config import SolverConfig
from parsy_bench_tpu.core import generate
from parsy_bench_tpu.core.csc import CSC
from parsy_bench_tpu.models import CholeskySolver as JaxCholeskySolver
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
    linv = ex.solve_prep(s.lx)
    assert ex.solve_prep(s.lx) is linv
    x1 = ex.solve_lower(s.lx, b).numpy()
    # new values on the same pattern: new pools, a new Linv pool
    s.factorize(CSC(a.n, a.indptr, a.indices, a.data * 4.0))
    linv2 = ex.solve_prep(s.lx)
    assert linv2 is not linv
    assert np.max(np.abs(ex.solve_lower(s.lx, b).numpy() - x1 / 2.0)) \
        <= 1e-12
    # the same pools changed in place: rebuilt as well, so the fast solve
    # reads the inverses now stored in the pools, as the leveled one does
    for p in s.lx:
        p.mul_(2.0)
    linv3 = ex.solve_prep(s.lx)
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
    a = generate.laplace_3d(8)
    with pytest.raises(NotImplementedError, match=r"ROADMAP §1, item 2"):
        CholeskySolver(a, _config("laplace3d8_nd", dense_top_cols=10**6,
                                  dense_top_thin=1000), device="cpu")
    with pytest.raises(NotImplementedError, match=r"ROADMAP §1, item 3"):
        CholeskySolver(a, _config("laplace3d8_nd", solve_gpool_mb=64),
                       device="cpu")
