"""Linear-elasticity stiffness matrices of a box mesh of trilinear
hexahedra, made by the benchmark itself.

A configuration of kind ``elastic`` names a box of ``dims = (ex, ey, ez)``
unit cubes (the elements along x, y and z), each an 8-node trilinear
hexahedron (Q1) of an isotropic material with Poisson's ratio ``poisson``,
integrated with 2 x 2 x 2 Gauss points.  The nodes of the z = 0 face are clamped and removed, so the free
nodes are ``(ex + 1) x (ey + 1) x ez``, numbered x fastest, and free node i
carries the displacement unknowns 3i, 3i + 1, 3i + 2 (x, y, z).

The pattern is every coupling of two nodes that share an element (the
27-node stencil, 3 x 3 unknowns a pair), explicit zeros stored; storage is
the lower half in CSC order, column by column with sorted rows, which is
what the solver takes.  A value set is the sum of the element matrices,
element e's scaled by its modulus E_e (uniform in ``moduli`` = [low, high)
from the seed): the tangent moduli of one Newton iteration.  The pattern
and the scatter map of every element entry to its stored position are made
once; a value set is one ``np.bincount`` over that map.

With the clamped face every value set is symmetric positive definite: each
element matrix is positive semidefinite with the 6 rigid-body motions as
its null space, and no rigid motion of the whole box leaves the clamped
face at rest.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np

#: the local nodes of an element, (i, j, k) with i fastest: local node
#: l = i + 2 j + 4 k lies at the element's corner (x + i, y + j, z + k)
CORNERS = np.array([(i, j, k) for k in (0, 1) for j in (0, 1)
                    for i in (0, 1)], dtype=np.int64)


def element_matrix(poisson: float) -> np.ndarray:
    """The 24 x 24 stiffness matrix of a unit cube of modulus 1, unknowns
    ordered 3 l + axis over the local nodes l (``CORNERS``): the sum over
    the 2 x 2 x 2 Gauss points of B^T D B det J, with B the strains
    (xx, yy, zz, xy, yz, zx; engineering shears) of the trilinear shape
    functions and D the isotropic elasticity matrix."""
    nu = float(poisson)
    lam = nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    mu = 0.5 / (1.0 + nu)
    d = np.zeros((6, 6))
    d[:3, :3] = lam
    d[np.arange(3), np.arange(3)] += 2.0 * mu
    d[np.arange(3, 6), np.arange(3, 6)] = mu
    sign = 2.0 * CORNERS - 1.0                 # (8, 3) natural corners
    g = 1.0 / np.sqrt(3.0)
    ke = np.zeros((24, 24))
    for pt in itertools.product((-g, g), repeat=3):
        xi = np.asarray(pt)
        f = 1.0 + sign * xi                    # (8, 3)
        dn = np.empty((8, 3))
        for a in range(3):
            others = [b for b in range(3) if b != a]
            # dN/dx = 2 dN/dxi on a unit cube (x = (xi + 1) / 2)
            dn[:, a] = 2.0 * 0.125 * sign[:, a] * np.prod(f[:, others], 1)
        bm = np.zeros((6, 24))
        for l in range(8):
            gx, gy, gz = dn[l]
            c = 3 * l
            bm[0, c], bm[1, c + 1], bm[2, c + 2] = gx, gy, gz
            bm[3, c], bm[3, c + 1] = gy, gx
            bm[4, c + 1], bm[4, c + 2] = gz, gy
            bm[5, c], bm[5, c + 2] = gz, gx
        ke += bm.T @ d @ bm * 0.125            # det J = 1/8, weights 1
    return 0.5 * (ke + ke.T)


@dataclasses.dataclass
class Pattern:
    """The lower half of one box's stiffness pattern in CSC order, and the
    scatter map of the element entries onto it."""
    elements: tuple
    n: int
    indptr: np.ndarray   # (n+1,) int32
    indices: np.ndarray  # (nnz,) int32, sorted within each column
    #: the stored position of each element entry kept (``local``), element
    #: by element
    pos: np.ndarray      # (kept,) int64
    #: the element of each entry of ``pos``
    elem: np.ndarray     # (kept,) int32
    #: the index into ``element_matrix``'s lower entries of each entry
    local: np.ndarray    # (kept,) int16
    #: the lower entries (p >= q) of the element matrix, flattened
    ke_lower: np.ndarray  # (300,) float64

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])


def element_dofs(elements) -> np.ndarray:
    """(elements, 24) global unknowns of each element's local unknowns, -1
    where the node is clamped; elements numbered x fastest."""
    ex, ey, ez = (int(k) for k in elements)
    nx, ny = ex + 1, ey + 1
    x, y, z = np.meshgrid(np.arange(ex), np.arange(ey), np.arange(ez),
                          indexing="ij")
    x, y, z = (v.transpose(2, 1, 0).ravel() for v in (x, y, z))
    cx, cy, cz = (x[:, None] + CORNERS[:, 0], y[:, None] + CORNERS[:, 1],
                  z[:, None] + CORNERS[:, 2])
    node = cx + nx * (cy + ny * (cz - 1))
    node = np.where(cz == 0, -1, node)                   # (E, 8)
    dof = 3 * node[:, :, None] + np.arange(3)            # (E, 8, 3)
    return np.where(node[:, :, None] < 0, -1, dof).reshape(-1, 24)


def pattern(elements, poisson: float) -> Pattern:
    """The lower-half CSC pattern of the box's stiffness matrix and its
    scatter map.  The global order of a free element's unknowns follows
    their local order, so an element's lower entries are its local p >= q."""
    elements = tuple(int(k) for k in elements)
    ex, ey, ez = elements
    n = 3 * (ex + 1) * (ey + 1) * ez
    dofs = element_dofs(elements)
    p, q = np.tril_indices(24)
    rows, cols = dofs[:, p], dofs[:, q]                  # (E, 300)
    keep = (rows >= 0) & (cols >= 0)
    elem = np.nonzero(keep)[0].astype(np.int32)
    local = np.nonzero(keep)[1].astype(np.int16)
    key = cols[keep] * np.int64(n) + rows[keep]
    del rows, cols, keep
    # CSC order is the order of col * n + row
    uniq, pos = np.unique(key, return_inverse=True)
    col = uniq // n
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(col, minlength=n), out=indptr[1:])
    ke = element_matrix(poisson)
    return Pattern(elements, n, indptr.astype(np.int32),
                   (uniq - col * n).astype(np.int32), pos.astype(np.int64),
                   elem, local, ke[p, q])


def values(pat: Pattern, moduli: np.ndarray) -> np.ndarray:
    """Lower-half CSC values (float64) of the sum of the element matrices,
    element e's scaled by ``moduli[e]``."""
    w = moduli[pat.elem] * pat.ke_lower[pat.local]
    return np.bincount(pat.pos, weights=w, minlength=pat.nnz)


def build(spec: dict, rng: np.random.Generator, count: int):
    """(pattern, ``count`` value sets) of a configuration's ``matrix``:
    ``dims`` (the elements along x, y and z), ``poisson`` and ``moduli``
    ([low, high))."""
    pat = pattern(spec["dims"], spec["poisson"])
    low, high = spec["moduli"]
    nelem = int(np.prod(pat.elements))
    return pat, [values(pat, rng.uniform(low, high, size=nelem))
                 for _ in range(count)]
