"""The port's plan verification and analysis artifacts against the JAX
package (a port of tests/test_verify.py; CPU, small):

* ``symbolic/verify.verify_plan`` on the port's plan gives the JAX
  function's stats on the JAX plan, for the four matrices of
  tests/test_verify.py, and raises the port's ``PlanError`` on a shifted
  finalize slice and a dropped update chunk; ``verify=True`` records
  ``verify_s``;
* ``save_analysis`` / ``from_artifact``: an f64 round trip (the same
  permutation, the factor residual within max(1e-10, 2 r0), the solve
  within 1e-3 of x = 1), the wrong matrix refused, the artifact's tier
  kept over the config's with a warning, and an artifact that the JAX
  package wrote refused.
"""
import numpy as np
import pytest

import jax

# as in every test file that shares a worker with JAX f64 tests
jax.config.update("jax_enable_x64", True)

import torch

from parsy_bench_tpu.config import SolverConfig as JaxSolverConfig
from parsy_bench_tpu.core import generate
from parsy_bench_tpu.models import CholeskySolver as JaxCholeskySolver
from parsy_bench_tpu.symbolic.verify import verify_plan as jax_verify_plan
from parsy_bench_tpu_torch import CholeskySolver, SolverConfig
from parsy_bench_tpu_torch.symbolic.verify import PlanError, verify_plan
from test_torch_native import reload_native_libs

# a test process that lost a native library's first-build race loads it
# now, so both packages' inspectors run native
reload_native_libs()

torch.set_num_threads(1)

MATS = ["tiny", "bcsstk14ish", "ecology_small", "apache_small"]


def _solver(a, **kw):
    return CholeskySolver(a, SolverConfig(ordering="amd", tier="supernodal",
                                          **kw), device="cpu")


@pytest.mark.parametrize("name", MATS)
def test_verify_plan_matches_jax(name):
    a = generate.SUITE[name]()
    s = _solver(a, verify=True)
    assert "verify_s" in s.timings
    stats = verify_plan(s.plan)
    assert stats["ok"] and stats["nsuper"] == s.plan.layout.part.nsuper
    ref = JaxCholeskySolver(a, JaxSolverConfig(ordering="amd",
                                               tier="supernodal"))
    assert stats == jax_verify_plan(ref.plan)


@pytest.mark.parametrize("what", ["finalize_slice", "dropped_chunk"])
def test_verify_plan_catches_corruption(what):
    """A finalize bucket's slice shifted by one panel height, or an update
    chunk dropped onto the dummy row: PlanError."""
    if what == "finalize_slice":
        plan = _solver(generate.SUITE["bcsstk14ish"]()).plan
        b = next(b for seg in plan.segments for b in seg.fin
                 if b.cnt.max() > 0)
        t = int(np.argmax(b.cnt))
        b.boff = b.boff.copy()
        b.boff[t] += b.H
    else:
        plan = _solver(generate.SUITE["apache_small"]()).plan
        seg, b = next((seg, b) for seg in plan.segments for b in seg.upd
                      if np.any(b.dst != seg.wslice[b.ccls]))
        dummy = seg.wslice[b.ccls]
        g, t, p = np.argwhere(np.any(b.dst != dummy, axis=-1))[0]
        b.dst = b.dst.copy()
        b.dst[g, t, p] = dummy
    with pytest.raises(PlanError):
        verify_plan(plan)


def test_artifact_round_trip(tmp_path):
    a = generate.SUITE["bcsstk14ish"]()
    s = _solver(a, dtype="float64").factorize()
    r0 = s.factor_residual()
    path = str(tmp_path / "analysis.pbt")
    s.save_analysis(path)
    with pytest.warns(UserWarning, match="overriding config tier"):
        s2 = CholeskySolver.from_artifact(
            a, path, SolverConfig(dtype="float64", verify=True),
            device="cpu")
    assert s2.config.tier == "supernodal" and "verify_s" in s2.timings
    assert s2.device == torch.device("cpu")
    assert np.array_equal(s2.perm, s.perm)
    s2.factorize()
    assert s2.factor_residual() <= max(1e-10, 2 * r0)
    x = s2.solve(a.spd_rhs_for_ones())
    assert np.allclose(x, 1.0, atol=1e-3)
    with pytest.raises(ValueError, match="artifact is for"):
        CholeskySolver.from_artifact(generate.SUITE["tiny"](), path,
                                     device="cpu")


def test_jax_artifact_refused(tmp_path):
    """An artifact the JAX package wrote holds its classes: the port
    refuses it, telling the caller to analyze again with the port."""
    a = generate.SUITE["tiny"]()
    path = str(tmp_path / "jax.pbt")
    JaxCholeskySolver(a, JaxSolverConfig(tier="supernodal")).save_analysis(
        path)
    with pytest.raises(ValueError, match="written by the JAX package"):
        CholeskySolver.from_artifact(a, path, device="cpu")
