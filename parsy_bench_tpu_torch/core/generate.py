"""Synthetic SPD test matrices.

The reference benchmarks on 17 SuiteSparse SPD matrices (scripts/dlMat.sh:4-21).
This environment has no network egress, so we provide generators spanning the
same structural classes:

* ``laplace_2d`` / ``laplace_3d`` — 5/7-point grid Laplacians (+ c*I), the
  structural class of ecology2 / thermal2 / apache2 / G3_circuit;
* ``fem_grid`` — vector-valued (multi-dof) 2D/3D grids with denser element
  coupling, the class of af_shell / audikw_1 / Flan_1565 (wide supernodes);
* ``random_spd`` — banded + random off-band pattern, diagonally dominated;
* ``tridiagonal`` / ``arrow`` — degenerate shapes that stress the scheduler
  (maximum-depth chains, single fat root).

All return lower-half CSC (i >= j) with node coordinates where geometry
exists, so geometric nested dissection can serve as the METIS stand-in.

The port's own copy of ``parsy_bench_tpu/core/generate.py`` (the
reference); only the package in its imports differs.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from parsy_bench_tpu_torch.core.csc import CSC


def _finish(m: sp.spmatrix, coords=None) -> CSC:
    m = sp.tril(m.tocsc(), 0).tocsc()
    m.sum_duplicates()
    m.sort_indices()
    return CSC.from_scipy(m, coords=coords)


def laplace_2d(nx: int, ny: int | None = None, shift: float = 0.05) -> CSC:
    """5-point Laplacian on an nx x ny grid, SPD via +shift*I."""
    ny = ny or nx
    ex = np.ones(nx)
    ey = np.ones(ny)
    tx = sp.diags([-ex[:-1], 2 * ex, -ex[:-1]], [-1, 0, 1])
    ty = sp.diags([-ey[:-1], 2 * ey, -ey[:-1]], [-1, 0, 1])
    a = sp.kronsum(tx, ty) + shift * sp.identity(nx * ny)
    yy, xx = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    coords = np.stack([xx.ravel(), yy.ravel()], axis=1).astype(np.float64)
    return _finish(a, coords)


def laplace_3d(nx: int, ny: int | None = None, nz: int | None = None,
               shift: float = 0.05) -> CSC:
    """7-point Laplacian on an nx x ny x nz grid."""
    ny = ny or nx
    nz = nz or nx
    def t(k):
        e = np.ones(k)
        return sp.diags([-e[:-1], 2 * e, -e[:-1]], [-1, 0, 1])
    a = sp.kronsum(sp.kronsum(t(nx), t(ny)), t(nz)) + shift * sp.identity(nx * ny * nz)
    zz, yy, xx = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                             indexing="ij")
    coords = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], axis=1).astype(np.float64)
    return _finish(a, coords)


def fem_grid(nx: int, ny: int | None = None, dof: int = 3, seed: int = 0,
             shift: float = 1.0) -> CSC:
    """Multi-dof 2D grid: each grid node carries ``dof`` unknowns, nodes are
    coupled to their 8 neighbours with dense dof x dof blocks.  Produces the
    wide-supernode profile of FEM matrices (af_shell / audikw class)."""
    ny = ny or nx
    rng = np.random.default_rng(seed)
    nn = nx * ny
    # 9-point stencil adjacency of the grid
    idx = np.arange(nn).reshape(ny, nx)
    rows, cols = [], []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            src = idx[max(0, dy):ny + min(0, dy), max(0, dx):nx + min(0, dx)]
            dst = idx[max(0, -dy):ny + min(0, -dy), max(0, -dx):nx + min(0, -dx)]
            rows.append(src.ravel())
            cols.append(dst.ravel())
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    adj = sp.csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(nn, nn))
    # expand to dof x dof random blocks, then make SPD as B @ B.T + shift*I
    block = sp.kron(adj, np.ones((dof, dof)))
    b = block.tocoo()
    vals = rng.standard_normal(b.nnz) / (3.0 * dof)
    m = sp.coo_matrix((vals, (b.row, b.col)), shape=b.shape).tocsc()
    a = (m + m.T) * 0.5
    a = a @ a.T + shift * sp.identity(nn * dof)
    yy, xx = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    coords = np.repeat(
        np.stack([xx.ravel(), yy.ravel()], axis=1), dof, axis=0
    ).astype(np.float64)
    return _finish(a, coords)


def random_spd(n: int, density: float = 0.01, band: int = 4, seed: int = 0) -> CSC:
    """Banded + random sparse SPD matrix, diagonally dominant."""
    rng = np.random.default_rng(seed)
    diags = [np.full(n, float(band + 2))]
    offsets = [0]
    for k in range(1, band + 1):
        diags.append(rng.uniform(-1, 1, n - k) * 0.5)
        offsets.append(-k)
    m = sp.diags(diags, offsets, format="lil")
    extra = int(density * n * n / 2)
    if extra:
        i = rng.integers(0, n, extra)
        j = rng.integers(0, n, extra)
        lo = np.minimum(i, j)
        hi = np.maximum(i, j)
        keep = lo != hi
        m[hi[keep], lo[keep]] = rng.uniform(-0.5, 0.5, keep.sum())
    m = m.tocsc()
    full = m + sp.tril(m, -1).T
    # enforce diagonal dominance -> SPD
    rowsum = np.abs(full).sum(axis=1).A.ravel() - full.diagonal()
    full.setdiag(rowsum + 1.0)
    return _finish(full)


def tridiagonal(n: int) -> CSC:
    """Worst-case chain: elimination tree is a path of length n."""
    e = np.ones(n)
    return _finish(sp.diags([-e[:-1], 2.5 * e, -e[:-1]], [-1, 0, 1]))


def arrow(n: int) -> CSC:
    """Arrow matrix: n-1 independent columns, one dense root row."""
    m = sp.lil_matrix((n, n))
    m.setdiag(np.full(n, n + 1.0))
    m[n - 1, :] = 1.0
    m[:, n - 1] = 1.0
    m[n - 1, n - 1] = n + 1.0
    return _finish(m.tocsc())


#: named suite used by tests and bench — (name, factory) in rough size order.
SUITE = {
    "tiny": lambda: random_spd(60, density=0.02, band=2, seed=1),
    "bcsstk14ish": lambda: fem_grid(14, 14, dof=3, seed=2),      # ~1.8k like bcsstk14
    "ecology_small": lambda: laplace_2d(64),                      # grid class
    "apache_small": lambda: laplace_3d(12),                       # 3D class
    "fem_medium": lambda: fem_grid(40, 40, dof=3, seed=3),        # af_shell class
}
