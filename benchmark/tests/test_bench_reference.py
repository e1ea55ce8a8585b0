"""The plain reference: it solves the benchmark's matrices, agrees with the
port on x, and the check fails the faults a cell can have.  The control
(the reference in TF32 in the program's place) needs the card."""
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from benchmark import grid, harness, reference
from benchmark.tests.common import SEED, bench, run_tiny, tiny_cell

CELLS = [w["name"] for w in bench()["workloads"]]
REFACTOR = [c for c in CELLS if c.endswith(".refactor")]
RESOLVE = [c for c in CELLS if c.endswith(".resolve")]


def _full(pat, data):
    m = sp.csc_matrix((data, pat.indices, pat.indptr), shape=(pat.n, pat.n))
    return (m + sp.tril(m, -1).T).tocsc()


@pytest.mark.parametrize("dims", [(7, 6, 5), (9, 8), (1, 5), (4,)])
def test_reference_solves_the_grid(dims):
    pat = grid.pattern(dims)
    rng = np.random.default_rng(SEED)
    data = grid.value_sets(pat, rng, 1, 0.5, 1.5, 0.05)[0]
    b = rng.standard_normal((pat.n, 3))
    want = spla.spsolve(_full(pat, data), b)
    got = reference.BandedCholesky(pat.indptr, pat.indices, data,
                                   "cpu").solve(b)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    one = reference.BandedCholesky(pat.indptr, pat.indices, data,
                                   "cpu").solve(b[:, 1])
    assert one.shape == (pat.n,)
    assert np.allclose(one, want[:, 1], rtol=0, atol=1e-12)


def test_grid_is_the_programs_generator_at_unit_coefficients():
    from parsy_bench_tpu_torch.core import generate
    for dims, a in (((5, 4, 3), generate.laplace_3d(5, 4, 3)),
                    ((6, 7), generate.laplace_2d(6, 7))):
        pat = grid.pattern(dims)
        assert np.array_equal(pat.indptr, a.indptr)
        assert np.array_equal(pat.indices, a.indices)
        assert np.array_equal(grid.ones(pat, 0.05), a.data)


def test_reference_refuses_an_indefinite_matrix():
    pat = grid.pattern((4, 4))
    data = -grid.ones(pat, 0.05)
    with pytest.raises(ValueError):
        reference.BandedCholesky(pat.indptr, pat.indices, data, "cpu")


@pytest.mark.parametrize("name", CELLS)
def test_port_agrees_with_reference(name):
    out = run_tiny(name, side=10)
    assert out["correct"] is True
    assert 0 < out["checks"]["x_err"]["value"] < 1e-5


class _Faulty:
    """The program with one fault planted under the harness."""

    def __init__(self, fault, *args):
        self.inner = harness.ProgramSystem(*args)
        self.fault = fault
        self.matrix = self.inner.matrix
        self.last = None
        self.factored = False

    def factorize(self, a):
        # a step that returns its state unchanged: the factor of the
        # first matrix stays
        if self.fault == "state_unchanged" and self.factored:
            return
        self.inner.factorize(a)
        self.factored = True

    def solve(self, b):
        x = self.inner.solve(b)
        if self.fault == "state_unchanged" and self.last is not None:
            x, self.last = self.last, x      # the answer of the step before
        elif self.fault == "state_unchanged":
            self.last = x
        if self.fault == "half_left_out":
            x = x.copy()
            x[len(x) // 2:] = 0
        if self.fault == "answer_altered":
            x = x.copy()
            x[len(x) // 3] += 1e-3 * np.abs(x).max()
        return x


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered"])
@pytest.mark.parametrize("name", REFACTOR[:1] + RESOLVE[:1])
def test_check_fails_a_faulty_program(name, fault):
    out = run_tiny(name, side=10, seconds=1.0,
                   make_system=lambda *a: _Faulty(fault, *a))
    assert out["correct"] is False
    x_err = out["checks"]["x_err"]
    assert x_err["value"] > x_err["limit"]


def test_failed_steps_fail_the_run():
    def failing(*args):
        system = harness.ProgramSystem(*args)

        def factorize(a):
            raise RuntimeError("planted")
        system.factorize = factorize
        return system
    out = run_tiny(REFACTOR[0], make_system=failing)
    assert out["correct"] is False and out["failed"] == out["attempted"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(name):
    """The reference in TF32, in the program's place, at a grid a test run
    holds (24 an axis in 3D, 200 in 2D), on three seeds: the check fails
    it.  The same seeds with the program pass."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import time
    cell = tiny_cell(name)
    d = len(cell.config["matrix"]["dims"])
    cell.config["matrix"]["dims"] = [24 if d == 3 else 200] * d
    for seed in (SEED, SEED + 1, SEED + 2):
        ctl = harness.run(cell, seed, 2.0, False, "cuda", time.perf_counter(),
                          make_system=lambda *a: harness.ReferenceSystem(
                              *a, precision="tf32"))
        ok = harness.run(cell, seed, 2.0, False, "cuda", time.perf_counter())
        print(name, seed, "control", ctl["checks"], "program", ok["checks"])
        assert ctl["correct"] is False
        assert ok["correct"] is True
