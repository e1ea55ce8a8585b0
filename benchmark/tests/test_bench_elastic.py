"""The matrix kind ``elastic`` (``benchmark/elastic.py``): the element
matrix, the assembled stiffness matrix at a small and at the configured
mesh, its inputs from the seed, and the cell's check of the program on the
CPU against the plain reference, with refinement and without it."""
import numpy as np
import pytest
import scipy.sparse as sp

from benchmark import elastic, harness, reference
from benchmark.tests.common import SEED, bench, run_tiny, tiny_cell

CELL = "elastic3d_q1_149k.refactor"
SPEC = {"dims": [3, 4, 5], "poisson": 0.3, "moduli": [0.5, 1.5]}


def _full(pat, v):
    m = sp.csc_matrix((v, pat.indices, pat.indptr), shape=(pat.n, pat.n))
    return (m + m.T - sp.diags(m.diagonal())).toarray()


def _rigid_motions():
    """The 6 rigid-body motions of the unit cube's corners: 3
    translations, 3 rotations (about z, x and y)."""
    c = elastic.CORNERS.astype(np.float64)
    out = []
    for a in range(3):
        u = np.zeros((8, 3))
        u[:, a] = 1.0
        out.append(u.ravel())
    for a, b in ((0, 1), (1, 2), (2, 0)):
        u = np.zeros((8, 3))
        u[:, a], u[:, b] = -c[:, b], c[:, a]
        out.append(u.ravel())
    return np.array(out)


def test_element_matrix_is_symmetric_psd_of_rank_18():
    ke = elastic.element_matrix(0.3)
    assert np.array_equal(ke, ke.T)
    w = np.linalg.eigvalsh(ke)
    tol = 1e-12 * w.max()
    assert w.min() > -tol
    assert int(np.sum(w > tol)) == 18


def test_rigid_motions_give_no_force():
    ke = elastic.element_matrix(0.3)
    modes = _rigid_motions()
    assert np.linalg.matrix_rank(modes) == 6
    assert np.abs(modes @ ke).max() < 1e-12 * np.abs(ke).max()


def test_assembled_matrix_is_spd_with_the_element_sums():
    """SPD; with every modulus 1 an interior node's diagonal block is the
    sum of its 8 elements' blocks."""
    rng = np.random.default_rng(SEED)
    pat, (v,) = elastic.build(SPEC, rng, 1)
    ex, ey, ez = SPEC["dims"]
    assert pat.n == 3 * (ex + 1) * (ey + 1) * ez
    a = _full(pat, v)
    assert np.allclose(a, a.T)
    assert np.linalg.eigvalsh(a).min() > 0
    ones = _full(pat, elastic.values(pat, np.ones(ex * ey * ez)))
    ke = elastic.element_matrix(0.3)
    # node (1, 1, 1) is interior: free node 1 + 4 (1 + 5 * 0)
    i = 3 * (1 + (ex + 1) * 1)
    want = sum(ke[3 * l:3 * l + 3, 3 * l:3 * l + 3] for l in range(8))
    assert np.allclose(ones[i:i + 3, i:i + 3], want)


def test_pattern_is_lower_csc_with_the_27_node_stencil():
    pat = elastic.pattern(SPEC["dims"], 0.3)
    col = np.repeat(np.arange(pat.n), np.diff(pat.indptr))
    assert np.all(pat.indices >= col)
    for j in range(pat.n):
        rows = pat.indices[pat.indptr[j]:pat.indptr[j + 1]]
        assert np.all(np.diff(rows) > 0) and rows[0] == j
    # an interior node couples to 27 nodes, 3 x 3 unknowns a pair
    ex, ey, _ = SPEC["dims"]
    node = 1 + (ex + 1) * (1 + (ey + 1) * 1)
    a = _full(pat, np.ones(pat.nnz))
    assert np.count_nonzero(a[3 * node]) == 27 * 3


def test_configured_mesh_has_bmwcra_1s_n():
    cfg = harness.find_cell(bench(), CELL).config
    pat = elastic.pattern(cfg["matrix"]["dims"], cfg["matrix"]["poisson"])
    assert pat.n == cfg["n"] == cfg["source_values"]["n"] == 148770
    assert pat.nnz == 5772105
    assert 2 * pat.nnz - pat.n == 11395440
    assert reference.half_bandwidth(pat.indptr, pat.indices) == 3398


def test_one_pattern_and_the_same_inputs_for_a_seed():
    cell = tiny_cell(CELL, side=3)
    make = cell.steps.make_inputs
    a, b, c = make(cell, SEED), make(cell, SEED), make(cell, SEED + 1)
    for x in (b, c):
        assert np.array_equal(a.pattern.indptr, x.pattern.indptr)
        assert np.array_equal(a.pattern.indices, x.pattern.indices)
    assert len(a.values) == cell.mix["value_sets"]
    for x, y, z in zip(a.values + a.rhs, b.values + b.rhs, c.values + c.rhs):
        assert np.array_equal(x, y) and x.shape == z.shape
        assert not np.array_equal(x, z)
    assert not np.array_equal(a.values[0], a.values[1])


def test_program_passes_the_cells_check():
    out = run_tiny(CELL, side=4, seconds=1.0)
    assert out["correct"] is True and out["failed"] == 0
    assert 0 < out["checks"]["x_err"]["value"] < 1e-12


class _Unrefined(harness.ProgramSystem):
    """The program with its refinement left out: a planted fault."""

    def __init__(self, pat, data0, fields, device):
        super().__init__(pat, data0, dict(fields, refine_steps=0), device)


def test_check_fails_the_program_without_refinement():
    out = run_tiny(CELL, side=4, seconds=1.0, make_system=_Unrefined)
    assert out["correct"] is False
    x_err = out["checks"]["x_err"]
    assert x_err["value"] > 100 * x_err["limit"]
