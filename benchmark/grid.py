"""Grid Laplacians with variable coefficients, made by the benchmark itself.

A configuration of kind ``grid`` names a d-dimensional grid of
``dims = (n0, n1, ...)`` nodes, fastest axis first, numbered
``i = x0 + n0 * (x1 + n1 * (x2 ...))`` as the program's
``core/generate.laplace_2d`` / ``laplace_3d`` number theirs.  The operator is
variable-coefficient diffusion on the (2d+1)-point stencil with Dirichlet
faces, plus ``shift`` on the diagonal:

* every face between two neighbours along an axis, and every boundary face,
  carries a coefficient c > 0;
* the off-diagonal entry of two neighbours is -c of the face between them;
* the diagonal entry of a node is the sum of the c of its 2d faces, plus
  ``shift``.

With every c = 1 this is the program's generator's matrix (2d + shift on
the diagonal, -1 beside it).  Every set of coefficients gives a symmetric,
strictly diagonally dominant matrix with a positive diagonal: SPD.

Storage is the lower half in CSC order, column by column with sorted rows,
which is what the solver takes.  The pattern is made once; a value set is
one gather from the vector ``[diagonal (n) | -interior faces (m)]``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass
class Pattern:
    """The lower half of one grid operator's pattern in CSC order."""
    dims: tuple
    n: int
    indptr: np.ndarray   # (n+1,) int32
    indices: np.ndarray  # (nnz,) int32, sorted within each column
    #: for each stored entry, its position in the value vector
    #: ``[diagonal (n) | -interior faces, axis by axis]``
    src: np.ndarray      # (nnz,) int64

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])


def _strides(dims):
    return [int(np.prod(dims[:a], dtype=np.int64)) for a in range(len(dims))]


def pattern(dims) -> Pattern:
    """The lower-half CSC pattern of the (2d+1)-point operator on ``dims``."""
    dims = tuple(int(k) for k in dims)
    n = int(np.prod(dims, dtype=np.int64))
    node = np.arange(n, dtype=np.int64).reshape(dims[::-1])
    rows, cols = [np.arange(n, dtype=np.int64)], [np.arange(n, dtype=np.int64)]
    for a, s in enumerate(_strides(dims)):
        ax = len(dims) - 1 - a            # numpy axis of grid axis a
        lo = np.take(node, np.arange(dims[a] - 1), axis=ax).ravel()
        rows.append(lo + s)               # the neighbour above: row > col
        cols.append(lo)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    ids = np.arange(1, len(rows) + 1, dtype=np.float64)
    m = sp.csc_matrix((ids, (rows, cols)), shape=(n, n))
    m.sort_indices()
    return Pattern(dims, n, m.indptr.astype(np.int32),
                   m.indices.astype(np.int32),
                   m.data.astype(np.int64) - 1)


def values(pat: Pattern, faces, shift: float) -> np.ndarray:
    """Lower-half CSC values (float64) from one coefficient per face.

    ``faces`` is one array per axis a, of the grid's shape (slowest axis
    first) with ``dims[a] + 1`` along axis a: face j lies below node j."""
    dims = pat.dims
    diag = np.full(dims[::-1], float(shift))
    off = []
    for a, f in enumerate(faces):
        ax = len(dims) - 1 - a
        k = dims[a]
        diag += (np.take(f, np.arange(k), axis=ax)
                 + np.take(f, np.arange(1, k + 1), axis=ax))
        # interior faces in the node order of their lower node
        off.append(-np.take(f, np.arange(1, k), axis=ax).ravel())
    vec = np.concatenate([diag.ravel()] + off)
    return vec[pat.src]


def face_shapes(dims):
    """The shape of each axis's face array (slowest axis first)."""
    out = []
    for a in range(len(dims)):
        shape = list(dims[::-1])
        shape[len(dims) - 1 - a] += 1
        out.append(tuple(shape))
    return out


def value_sets(pat: Pattern, rng: np.random.Generator, count: int,
               low: float, high: float, shift: float) -> list:
    """``count`` value sets, each face coefficient uniform in [low, high)."""
    return [values(pat, [rng.uniform(low, high, size=s)
                         for s in face_shapes(pat.dims)], shift)
            for _ in range(count)]


def ones(pat: Pattern, shift: float) -> np.ndarray:
    """The values with every face coefficient 1: the program's generator's
    constant-coefficient Laplacian."""
    return values(pat, [np.ones(s) for s in face_shapes(pat.dims)], shift)


def build(spec: dict, rng: np.random.Generator, count: int):
    """(pattern, ``count`` value sets) of a configuration's ``matrix``:
    ``dims``, ``shift`` and ``coefficients`` ([low, high])."""
    pat = pattern(spec["dims"])
    low, high = spec["coefficients"]
    return pat, value_sets(pat, rng, count, low, high, spec["shift"])
