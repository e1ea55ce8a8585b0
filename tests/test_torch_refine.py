"""Mixed-precision iterative refinement in ``CholeskySolver.solve``: a
float32 factor, residuals in float64 on the device against the values of
the latest ``factorize``, x kept in float64.

The matrices are small linear-elasticity stiffness matrices of
``benchmark/elastic.py`` (Q1 hexahedra, 3 unknowns a node): two value
sets on one pattern, so that a refinement against the analysed values
instead of the latest ones shows.  The float64 answer is scipy's sparse
LU of the whole symmetric matrix.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as sla
import torch

from benchmark import elastic
from parsy_bench_tpu_torch.config import SolverConfig
from parsy_bench_tpu_torch.core.csc import CSC
from parsy_bench_tpu_torch.models import CholeskySolver
from parsy_bench_tpu_torch.ops import residual

torch.set_num_threads(1)

TIERS = ["supernodal", "simplicial"]
SPEC = {"dims": [4, 5, 6], "poisson": 0.3, "moduli": [0.5, 1.5]}


@pytest.fixture(scope="module")
def mats():
    """(pattern, two value sets, a right-hand side, float64 x of the
    second value set)."""
    rng = np.random.default_rng(2026)
    pat, vals = elastic.build(SPEC, rng, 2)
    b = rng.standard_normal(pat.n)
    x = sla.spsolve(_full(pat.indptr, pat.indices, vals[1]), b)
    return pat, vals, b, x


def _full(indptr, indices, v):
    """The whole symmetric matrix of a lower-half CSC."""
    n = len(indptr) - 1
    m = sp.csc_matrix((v, indices, indptr), shape=(n, n))
    return (m + m.T - sp.diags(m.diagonal())).tocsc()


def _csc(pat, v):
    return CSC(pat.n, pat.indptr, pat.indices, v)


def _refactored(mats, tier, steps):
    """A solver analysed on the first value set, factorized on it and
    then on the second."""
    pat, vals, _, _ = mats
    s = CholeskySolver(_csc(pat, vals[0]),
                       SolverConfig(ordering="nd", dtype="float32",
                                    tier=tier, refine_steps=steps),
                       device="cpu")
    s.factorize(_csc(pat, vals[0]))
    return s.factorize(_csc(pat, vals[1]))


def _err(x, want):
    return np.max(np.abs(x - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("tier", TIERS)
def test_refined_solve_after_refactor_is_float64_accurate(mats, tier):
    """Two sweeps after ``factorize`` of new values reach the float64
    solve of the new matrix, not of the analysed one."""
    _, _, b, want = mats
    s = _refactored(mats, tier, 2)
    assert _err(s.solve(b), want) < 1e-12


@pytest.mark.parametrize("tier", TIERS)
def test_refinement_gains_three_orders(mats, tier):
    _, _, b, want = mats
    e0 = _err(_refactored(mats, tier, 0).solve(b), want)
    e2 = _err(_refactored(mats, tier, 2).solve(b), want)
    assert e0 < 1e-4
    assert e2 * 1e3 <= e0


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("steps", [0, 1, 2])
def test_dtype_and_sweep_counter(mats, tier, steps):
    """float64 with refinement, the factor's float32 without; the counter
    holds the sweeps the last solve ran."""
    _, _, b, _ = mats
    s = _refactored(mats, tier, steps)
    x = s.solve(b)
    assert x.dtype == (np.float64 if steps else np.float32)
    assert x.shape == (len(b),)
    assert s.refine_sweeps == steps


def test_each_sweep_shrinks_the_error(mats):
    _, _, b, want = mats
    errs = [_err(_refactored(mats, "supernodal", k).solve(b), want)
            for k in (0, 1, 2)]
    assert errs[0] > errs[1] > errs[2]


@pytest.mark.parametrize("tier", TIERS)
def test_device_residual_is_scipys(mats, tier):
    """The solver's residual operator on its values in the factor's order
    is scipy's b - A x there, to 1e-13 of |A| |x| + |b|."""
    _, _, b, _ = mats
    s = _refactored(mats, tier, 2)
    s.solve(b)
    ap = s.ap
    full = _full(ap.indptr, ap.indices, s._a64.numpy())
    rng = np.random.default_rng(1)
    bp, x = rng.standard_normal(ap.n), rng.standard_normal(ap.n)
    got = s._residual(s._a64, torch.as_tensor(bp), torch.as_tensor(x))
    want = bp - full @ x
    scale = abs(full) @ np.abs(x) + np.abs(bp)
    assert got.dtype == torch.float64
    assert np.max(np.abs(got.numpy() - want) / scale) < 1e-13


@pytest.mark.parametrize("shuffled", [False, True])
@pytest.mark.parametrize("diagonal", [True, False])
def test_residual_on_a_random_pattern(diagonal, shuffled):
    """Any lower-half pattern, with or without its diagonal stored, with
    empty columns, its rows sorted in each column or not."""
    rng = np.random.default_rng(7)
    n = 60
    m = sp.random(n, n, density=0.08, random_state=3, format="csc")
    m = sp.tril(m, 0 if diagonal else -1).tocsc()
    m.data[m.indptr[5]:m.indptr[6]] = 0
    m.eliminate_zeros()
    m.sort_indices()
    full = _full(m.indptr, m.indices, m.data)
    if shuffled:
        for j in range(n):
            lo, hi = m.indptr[j], m.indptr[j + 1]
            p = lo + rng.permutation(hi - lo)
            m.indices[lo:hi], m.data[lo:hi] = m.indices[p], m.data[p]
    op = residual.SymmetricResidual(m.indptr, m.indices,
                                    torch.device("cpu"))
    b, x = rng.standard_normal(n), rng.standard_normal(n)
    got = op(torch.as_tensor(m.data), torch.as_tensor(b),
             torch.as_tensor(x)).numpy()
    assert np.max(np.abs(got - (b - full @ x))) < 1e-13


@pytest.mark.parametrize("tier", TIERS)
def test_each_residual_is_the_operations_the_benchmark_reads(mats, tier):
    """Under a profile each ``solver.residual`` holds b's copy, two
    gathers, their product and one scatter-add, in that order: the
    operations ``benchmark/refinetrace.py`` counts back from the
    scatter-add."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark import refinetrace
    _, _, b, _ = mats
    s = _refactored(mats, tier, 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s.solve(b)
    evs = prof.events()
    spans = [e for e in evs if e.name == "solver.residual"]
    assert len(spans) == 2
    for sp_ in spans:
        ops = [e.name for e in evs
               if e.cpu_parent is sp_ and e.name.startswith("aten::")]
        assert ops == ["aten::clone", "aten::index_select",
                       "aten::index_select", "aten::mul", "aten::index_add_"]
        assert len(ops) == refinetrace.RESIDUAL_OPS


@pytest.mark.parametrize("tier", TIERS)
def test_without_refinement_factorize_keeps_no_float64_copy(mats, tier,
                                                            monkeypatch):
    """With ``refine_steps`` 0 the executor gets the values gathered in
    its own dtype, as before; no float64 copy and no residual operator
    are made, and the factorize's gather is its one ``index_select``."""
    pat, vals, b, _ = mats
    s = _refactored(mats, tier, 0)
    got = []
    fac = s.executor.factorize
    monkeypatch.setattr(s.executor, "factorize",
                        lambda data: got.append(data) or fac(data))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s.factorize(_csc(pat, vals[1]))
    s.solve(b)
    (data,) = got
    assert isinstance(data, torch.Tensor) and data.dtype == torch.float32
    assert s._a64 is None and s._residual is None
    (permute,) = [e for e in prof.events()
                  if e.name == "solver.permute_values"]
    gathers = [e for e in prof.events()
               if e.name == "aten::index_select" and _under(e, permute)]
    assert len(gathers) == 1


def _under(e, p):
    """Whether profiler event ``e`` runs inside event ``p``."""
    while e is not None:
        if e is p:
            return True
        e = e.cpu_parent
    return False


def test_refinement_needs_a_refining_factorize(mats):
    """A factor made without refinement holds no float64 values: a solve
    asked to refine against it raises instead of using stale ones."""
    _, _, b, _ = mats
    s = _refactored(mats, "supernodal", 0)
    s.config = s.config.replace(refine_steps=2)
    with pytest.raises(RuntimeError, match="refine_steps"):
        s.solve(b)


def test_factorize_without_values_refines_against_the_analysed_ones(mats):
    pat, vals, b, _ = mats
    s = _refactored(mats, "supernodal", 2)
    s.factorize()
    want = sla.spsolve(_full(pat.indptr, pat.indices, vals[0]), b)
    assert _err(s.solve(b), want) < 1e-12
