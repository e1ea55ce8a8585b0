"""``CholeskySolver``'s value map: where each entry of the permuted matrix
lies in the analysed ``a.data``, fixed at analysis, and the gather on the
device that ``factorize(a)`` runs with it in place of a host permutation.

* The map reproduces ``a.permute(perm).data`` bit for bit (grids, a random
  pattern; ``nd``, ``amd``, ``natural``; both tiers), and a solver restored
  from an artifact builds the same map.
* The factor from ``factorize(a)`` equals bit for bit the one the
  executor gives for the host permutation of the same values.
* A pattern other than the analysed one raises ``ValueError``; a whole
  symmetric ``a`` is cut to its lower half first, so the same matrix
  stored as its upper half raises.
* An ``a`` that stores an entry twice is refused at analysis.
* A value set with an exact zero off the diagonal factorizes and solves:
  the host permutation drops such an entry.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from parsy_bench_tpu_torch.config import SolverConfig
from parsy_bench_tpu_torch.core import generate
from parsy_bench_tpu_torch.core.csc import CSC
from parsy_bench_tpu_torch.models import CholeskySolver

# one intra-op thread per test process: the suite runs several workers
torch.set_num_threads(1)

MATRICES = {
    "grid2d": lambda: generate.laplace_2d(9, 7),
    "grid3d": lambda: generate.laplace_3d(5),
    "random": lambda: generate.random_spd(70, density=0.03, band=3, seed=4),
}
TIERS = ("supernodal", "simplicial")


def _solver(a, tier, ordering="amd", **kw):
    cfg = SolverConfig(tier=tier, ordering=ordering, dtype="float32")
    return CholeskySolver(a, cfg, device="cpu", **kw)


def _new_values(a: CSC, seed: int) -> CSC:
    """``a``'s pattern, the very arrays, with other SPD values: every
    off-diagonal entry scaled in [0.5, 1), the diagonal kept."""
    rng = np.random.default_rng(seed)
    col = np.repeat(np.arange(a.n), np.diff(a.indptr))
    scale = np.where(a.indices == col, 1.0, rng.uniform(0.5, 1.0, a.nnz))
    return CSC(a.n, a.indptr, a.indices, a.data * scale)


def _factor(solver):
    """The held factor as one list of tensors (pools, or the L values)."""
    lx = solver.lx
    return list(lx) if isinstance(lx, tuple) else [lx]


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("ordering", ["nd", "amd", "natural"])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_map_reproduces_host_permutation(name, ordering, tier):
    a = MATRICES[name]()
    s = _solver(a, tier, ordering)
    ref = s.a.permute(s.perm)
    assert s._vmap_dev.dtype == torch.int32
    vmap = s._vmap_dev.cpu().numpy()
    assert len(vmap) == s.a.nnz
    np.testing.assert_array_equal(s.a.data[vmap], ref.data, strict=True)
    # the analysed ap is the one the host permutation gives
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(s.ap, f), getattr(ref, f),
                                      strict=True)
    b = _new_values(s.a, 1)
    np.testing.assert_array_equal(b.data[vmap], b.permute(s.perm).data,
                                  strict=True)


@pytest.mark.parametrize("tier", TIERS)
def test_artifact_restores_the_same_map(tier, tmp_path):
    a = MATRICES["grid3d"]()
    s = _solver(a, tier, "nd")
    path = str(tmp_path / "analysis.pkl")
    s.save_analysis(path)
    r = CholeskySolver.from_artifact(
        a, path, SolverConfig(tier=tier, dtype="float32"), device="cpu")
    assert torch.equal(r._vmap_dev, s._vmap_dev)
    np.testing.assert_array_equal(r.ap.data, s.ap.data, strict=True)
    b = _new_values(r.a, 2)
    r.factorize(b)
    s.factorize(b)
    for x, y in zip(_factor(r), _factor(s)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_factor_equals_the_host_permutations(name, tier):
    a = MATRICES[name]()
    s = _solver(a, tier, "nd")
    for seed in (3, 4):
        b = _new_values(s.a, seed)
        got = _factor(s.factorize(b))
        want = s.executor.factorize(b.permute(s.perm).data)
        want = list(want) if isinstance(want, tuple) else [want]
        assert len(got) == len(want)
        for x, y in zip(got, want):
            assert x.dtype == torch.float32 and torch.equal(x, y)
    # equal arrays that are not the analysed ones take the same path
    c = _new_values(s.a, 5)
    c = CSC(c.n, c.indptr.copy(), c.indices.copy(), c.data)
    got = _factor(s.factorize(c))
    want = s.executor.factorize(c.permute(s.perm).data)
    for x, y in zip(got, want if isinstance(want, tuple) else [want]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("tier", TIERS)
def test_another_pattern_of_equal_nnz_raises(tier):
    a = MATRICES["grid2d"]()
    s = _solver(a, tier)
    # move column 0's last entry to a row it does not store: the same nnz,
    # still lower-half
    ip, ix = s.a.indptr, s.a.indices.copy()
    free = np.setdiff1d(np.arange(1, a.n), ix[ip[0]:ip[1]])
    ix[ip[1] - 1] = free[-1]
    other = CSC(a.n, ip, ix, s.a.data.copy())
    assert other.is_lower() and other.nnz == s.a.nnz
    with pytest.raises(ValueError, match="pattern"):
        s.factorize(other)
    short = CSC(a.n, s.a.indptr, s.a.indices, s.a.data[:-1])
    with pytest.raises(ValueError, match="A values"):
        s.factorize(short)


@pytest.mark.parametrize("tier", TIERS)
def test_whole_symmetric_a_takes_its_lower_half(tier):
    """A whole symmetric ``a`` is cut to its lower half, as ``__init__``
    cuts it, and gives the lower half's factor bit for bit."""
    a = MATRICES["grid2d"]()
    s = _solver(a, tier)
    b = _new_values(s.a, 6)
    full = b.symmetrize_from_lower()
    assert not full.is_lower()
    got = [x.clone() for x in _factor(s.factorize(full))]
    assert s.factor_ok()
    for x, y in zip(got, _factor(s.factorize(b))):
        assert torch.equal(x, y)


@pytest.mark.parametrize("tier", TIERS)
def test_upper_half_of_equal_nnz_raises(tier):
    """The analysed matrix stored as its upper half has the analysed nnz
    but not its pattern."""
    a = MATRICES["grid2d"]()
    s = _solver(a, tier)
    upper = _new_values(s.a, 6).transpose()
    assert not upper.is_lower() and upper.nnz == s.a.nnz
    with pytest.raises(ValueError, match="pattern"):
        s.factorize(upper)
    # the solver still factorizes its own pattern afterwards
    s.factorize(_new_values(s.a, 7))
    assert s.factor_ok()


@pytest.mark.parametrize("tier", TIERS)
def test_entry_stored_twice_raises(tier, tmp_path):
    a = MATRICES["grid2d"]()
    s = _solver(a, tier)
    path = str(tmp_path / "analysis.pkl")
    s.save_analysis(path)
    # store column 3's diagonal entry twice, half its value in each
    ip, ix, x = s.a.indptr, s.a.indices, s.a.data
    k = ip[3]
    assert ix[k] == 3
    dup = CSC(a.n, np.concatenate([ip[:4], ip[4:] + 1]).astype(ip.dtype),
              np.insert(ix, k, 3).astype(ix.dtype),
              np.insert(x, k, x[k] / 2))
    dup.data[k + 1] = x[k] / 2
    assert dup.is_lower() and dup.nnz == s.a.nnz + 1
    with pytest.raises(ValueError, match="twice"):
        _solver(dup, tier)
    with pytest.raises(ValueError, match="twice"):
        CholeskySolver.from_artifact(
            dup, path, SolverConfig(tier=tier, dtype="float32"),
            device="cpu")


@pytest.mark.parametrize("tier", TIERS)
def test_exact_zero_off_diagonal_factorizes(tier):
    a = MATRICES["grid3d"]()
    s = _solver(a, tier, "nd")
    b = _new_values(s.a, 7)
    col = np.repeat(np.arange(b.n), np.diff(b.indptr))
    off = np.flatnonzero(b.indices != col)
    b.data[off[[0, len(off) // 2, -1]]] = 0.0
    # the host permutation drops the zeros: it had too few values
    assert len(b.permute(s.perm).data) == b.nnz - 3
    s.factorize(b)
    assert s.factor_ok()
    rhs = np.random.default_rng(8).standard_normal(b.n)
    x = s.solve(rhs)
    full = b.symmetrize_from_lower().to_scipy()
    want = sp.linalg.spsolve(full.tocsc(), rhs)
    assert np.max(np.abs(x - want)) / np.max(np.abs(want)) < 1e-4
