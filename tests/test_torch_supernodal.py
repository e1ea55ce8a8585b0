"""The port's supernodal inspector copy and executor against the JAX
package, on the same matrices, configurations and inputs (CPU, small).

* plan equality: the port's own inspector (its copies of the ordering,
  etree, column counts and ``build_supernodal_plan``, and its own
  ``SolverConfig``) gives the JAX permutation, etree and column counts and
  emits the JAX plan field by field, down to every table array;
* executor: after ``factorize`` the packed pools agree element-wise,
  ``factor_values`` agrees, and ``solve_lower`` / ``solve_upper`` /
  ``solve_spd`` agree on the same b.  Bars: 1e-10 in f64; 1e-3 of the
  largest pool entry in f32 (the reference's f32 bar);
* state carried across: JAX pools converted with ``pools_from_numpy``
  solve in the port exactly as in JAX.
"""
import dataclasses
import functools

import numpy as np
import pytest
import scipy.sparse as sp

import jax

jax.config.update("jax_enable_x64", True)

import torch

from parsy_bench_tpu.config import SolverConfig
from parsy_bench_tpu.core import generate
from parsy_bench_tpu.models import CholeskySolver as JaxCholeskySolver
from parsy_bench_tpu_torch import CholeskySolver
from parsy_bench_tpu_torch import SolverConfig as PortConfig
from parsy_bench_tpu_torch.core import generate as port_generate
from parsy_bench_tpu_torch.ops.convert import (pools_from_numpy,
                                               pools_to_numpy)
from test_torch_native import reload_native_libs

# a test process that lost a native library's first-build race
# loads it now, so both packages' inspectors run native
reload_native_libs()

# one intra-op thread per test process: the suite runs several pytest
# workers at once, and torch's default pool (one thread per core) in each
# of them oversubscribes the cores many times over on these small ops
torch.set_num_threads(1)

#: name -> (matrix factory of a ``generate`` module, SolverConfig
#: overrides)
CASES = {
    "tiny_amd": (lambda g: g.SUITE["tiny"](), dict(ordering="amd")),
    "tiny_amd_scatter": (lambda g: g.SUITE["tiny"](),
                         dict(ordering="amd", update_delta="scatter")),
    "bcsstk14ish_amd": (lambda g: g.SUITE["bcsstk14ish"](),
                        dict(ordering="amd")),
    "laplace3d8_nd": (lambda g: g.laplace_3d(8), dict(ordering="nd")),
    "laplace3d8_nd_scatter": (lambda g: g.laplace_3d(8),
                              dict(ordering="nd", update_delta="scatter")),
    # fin_bucket_elems=4096 splits finalize and update buckets and the
    # shared-chol batches
    "laplace2d16_amd_split": (lambda g: g.laplace_2d(16),
                              dict(ordering="amd", fin_bucket_elems=4096)),
}


def _config(case, dtype):
    return SolverConfig(tier="supernodal", dtype=dtype, **CASES[case][1])


def _assert_same(x, y, path):
    if dataclasses.is_dataclass(x):
        assert type(x).__name__ == type(y).__name__, path
        for f in dataclasses.fields(x):
            _assert_same(getattr(x, f.name), getattr(y, f.name),
                         f"{path}.{f.name}")
    elif isinstance(x, np.ndarray):
        assert isinstance(y, np.ndarray), path
        assert x.dtype == y.dtype and np.array_equal(x, y), path
    elif sp.issparse(x):
        assert sp.issparse(y) and x.shape == y.shape, path
        assert (x != y).nnz == 0, path
    elif isinstance(x, (list, tuple)):
        assert type(x) is type(y) and len(x) == len(y), path
        for i, (u, v) in enumerate(zip(x, y)):
            _assert_same(u, v, f"{path}[{i}]")
    elif isinstance(x, dict):
        assert x.keys() == y.keys(), path
        for k in x:
            _assert_same(x[k], y[k], f"{path}[{k!r}]")
    elif callable(x):
        # the layout's lazy simplicial pattern; both come from the shared
        # supernodes module
        assert callable(y), path
    else:
        assert x == y, (path, x, y)


@pytest.mark.parametrize("case", ["tiny_amd", "bcsstk14ish_amd",
                                  "laplace3d8_nd", "laplace3d8_nd_scatter"])
def test_plan_matches_jax(case):
    """Each package's solver from its own matrix generator, config and
    inspector: the same matrix, permutation, etree, column counts and
    plan."""
    a = CASES[case][0](port_generate)
    aj = CASES[case][0](generate)
    for x, y in ((a.indptr, aj.indptr), (a.indices, aj.indices),
                 (a.data, aj.data)):
        assert np.array_equal(x, y)
    pcfg = PortConfig(tier="supernodal", dtype="float64", **CASES[case][1])
    assert type(pcfg).__module__ == "parsy_bench_tpu_torch.config"
    port = CholeskySolver(a, pcfg, device="cpu")
    ref = JaxCholeskySolver(aj, _config(case, "float64"))
    assert np.array_equal(port.perm, ref.perm)
    assert np.array_equal(port.parent, ref.parent)
    assert np.array_equal(port.cc, ref.cc)
    has_gsc = any(seg.gsc is not None for seg in port.plan.segments)
    assert has_gsc == (pcfg.update_delta == "gather")
    _assert_same(port.plan, ref.plan, "plan")


@functools.lru_cache(maxsize=None)
def _run(case, dtype):
    """Both executors on one matrix: (port solver, jax solver, jax pools,
    b, jax results)."""
    a = CASES[case][0](generate)
    cfg = _config(case, dtype)
    port = CholeskySolver(a, cfg, device="cpu").factorize()
    ref = JaxCholeskySolver(a, cfg).factorize()
    b = np.random.default_rng(11).standard_normal(a.n)
    jex = ref.executor
    res = dict(values=np.asarray(jex.factor_values(ref.lx)),
               lower=np.asarray(jex.solve_lower(ref.lx, b)),
               upper=np.asarray(jex.solve_upper(ref.lx, b)),
               spd=np.asarray(jex.solve_spd(ref.lx, b)))
    return port, ref, [np.asarray(p) for p in ref.lx], b, res


@pytest.mark.parametrize("case,dtype", [
    ("tiny_amd", "float64"), ("tiny_amd", "float32"),
    ("tiny_amd_scatter", "float64"), ("laplace2d16_amd_split", "float64")])
def test_executor_matches_jax(case, dtype):
    port, ref, jpools, b, res = _run(case, dtype)
    pools = pools_to_numpy(port.lx)
    scale = max(np.abs(p).max() for p in jpools)
    tol = 1e-10 if dtype == "float64" else 1e-3 * scale
    assert len(pools) == len(jpools)
    for p, q in zip(pools, jpools):
        assert p.shape == q.shape and p.dtype == q.dtype
        assert np.max(np.abs(p - q)) <= tol
    ex = port.executor
    assert np.max(np.abs(ex.factor_values(port.lx).numpy()
                         - res["values"])) <= tol
    for key, fn in (("lower", ex.solve_lower), ("upper", ex.solve_upper),
                    ("spd", ex.solve_spd)):
        x = fn(port.lx, b).numpy()
        bar = 1e-10 if dtype == "float64" else (
            1e-3 * max(1.0, np.abs(res[key]).max()))
        assert np.max(np.abs(x - res[key])) <= bar, key


def test_split_plan_splits():
    """The forced-split case really splits buckets and chol batches."""
    port, _, _, _, _ = _run("laplace2d16_amd_split", "float64")
    base = CholeskySolver(CASES["laplace2d16_amd_split"][0](generate),
                          SolverConfig(tier="supernodal", ordering="amd",
                                       dtype="float64"), device="cpu")
    nfin = [sum(len(s.fin) for s in x.plan.segments) for x in (port, base)]
    assert nfin[0] > nfin[1]
    assert (port.executor.chol_calls_per_factorize
            > base.executor.chol_calls_per_factorize)


@pytest.mark.parametrize("case", ["tiny_amd", "laplace2d16_amd_split"])
def test_jax_pools_solve_in_port(case):
    """State carried across: the JAX factor, converted, solves in the
    port as it does in JAX."""
    port, _, jpools, b, res = _run(case, "float64")
    pools = pools_from_numpy(jpools, "cpu", "float64")
    assert all(p.dtype == torch.float64 for p in pools)
    x = port.executor.solve_spd(pools, b).numpy()
    assert np.max(np.abs(x - res["spd"])) <= 1e-10
    # the fast forward solve (solve_prep on the converted pools)
    x = port.executor.solve_lower(pools, b).numpy()
    assert np.max(np.abs(x - res["lower"])) <= 1e-10
    back = pools_to_numpy(pools)
    assert all(np.array_equal(p, q) for p, q in zip(back, jpools))
