"""Lazy g++ build + ctypes loader for the native symbolic library.

The shared object is rebuilt whenever the source hash changes; a build or
load failure makes ``load()`` raise, which ``parsy_bench_tpu_torch.native``
swallows into the pure-NumPy fallback.  Concurrent first builds are safe:
the build runs under an exclusive lock on ``_build/build.lock``.

The port's own copy of ``parsy_bench_tpu/native/build.py`` (the
reference), with the lock added to ``load()``.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "symbolic.cpp")
_BUILD = os.path.join(_HERE, "_build")

_I32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_I64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_F64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_U8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_c64 = ctypes.c_int64


class NativeLib:
    """Typed wrappers matching the NumPy specifications in
    parsy_bench_tpu_torch.symbolic (same argument conventions)."""

    def __init__(self, dll: ctypes.CDLL):
        self._dll = dll
        dll.pbt_etree.argtypes = [_c64, _I64, _I32, _I32]
        dll.pbt_postorder.argtypes = [_c64, _I64, _I32, _I32, _c64, _I32]
        dll.pbt_subtree_accumulate.argtypes = [_c64, _I32, _F64]
        dll.pbt_tree_depths.argtypes = [_c64, _I32, _I64]
        dll.pbt_tree_wavefront.argtypes = [_c64, _I32, _I64]
        dll.pbt_col_counts.argtypes = [_c64, _I64, _I32, _I32, _I64]
        dll.pbt_symbolic_pattern.argtypes = [_c64, _I64, _I32, _I32, _I64, _I32]
        dll.pbt_dag_levels.argtypes = [_c64, _I64, _I32, _I64]
        dll.pbt_cholesky_updates.argtypes = [_c64, _I64, _I32, _I32, _I32,
                                             _I32]
        dll.pbt_amd_order.argtypes = [_c64, _I64, _I32, _I32]
        dll.pbt_relaxed_amalgamation.argtypes = [
            _c64, _I64, _I32, _I64, _I64, _F64, _I64, _F64, _c64, _U8]
        dll.pbt_nd_order.argtypes = [_c64, _I64, _I32, _c64, _I32]
        dll.pbt_supernodal_rows.argtypes = [_c64, _I64, _I32, _I32, _I32,
                                            _c64, _I64, _I32, _c64]

    def etree(self, n, indptr, indices):
        parent = np.empty(n, dtype=np.int32)
        self._dll.pbt_etree(n, np.ascontiguousarray(indptr, np.int64),
                            np.ascontiguousarray(indices, np.int32), parent)
        return parent

    def postorder(self, n, childptr, children, roots):
        post = np.empty(n, dtype=np.int32)
        self._dll.pbt_postorder(
            n, np.ascontiguousarray(childptr, np.int64),
            np.ascontiguousarray(children, np.int32),
            np.ascontiguousarray(roots, np.int32), len(roots), post)
        return post

    def subtree_accumulate(self, parent, out):
        self._dll.pbt_subtree_accumulate(len(parent), parent, out)

    def tree_depths(self, parent, depth):
        self._dll.pbt_tree_depths(len(parent), parent, depth)

    def tree_wavefront(self, parent, lev):
        self._dll.pbt_tree_wavefront(len(parent), parent, lev)

    def col_counts(self, n, indptr, indices, parent):
        cc = np.empty(n, dtype=np.int64)
        self._dll.pbt_col_counts(n, np.ascontiguousarray(indptr, np.int64),
                                 np.ascontiguousarray(indices, np.int32),
                                 parent, cc)
        return cc

    def symbolic_pattern(self, n, indptr, indices, parent):
        cc = self.col_counts(n, indptr, indices, parent)
        nnz = int(cc.sum())
        rptr = np.empty(n + 1, dtype=np.int64)
        rind = np.empty(nnz, dtype=np.int32)
        self._dll.pbt_symbolic_pattern(
            n, np.ascontiguousarray(indptr, np.int64),
            np.ascontiguousarray(indices, np.int32), parent, rptr, rind)
        return rptr, rind

    def dag_levels(self, lptr, lind):
        n = len(lptr) - 1
        lev = np.zeros(n, dtype=np.int64)
        self._dll.pbt_dag_levels(n, np.ascontiguousarray(lptr, np.int64),
                                 np.ascontiguousarray(lind, np.int32), lev)
        return lev

    def amd_order(self, full) -> np.ndarray:
        """AMD ordering of a full symmetric scipy sparse matrix; returns
        perm with perm[new] = old (reference: AMD.h:298 AMD_order)."""
        m = full.tocsc()
        n = m.shape[0]
        perm = np.empty(n, dtype=np.int32)
        self._dll.pbt_amd_order(
            n, np.ascontiguousarray(m.indptr, np.int64),
            np.ascontiguousarray(m.indices, np.int32), perm)
        return perm

    def supernodal_rows(self, atp, ati, parent, col2sup, nsuper):
        """(rptr, rows) supernodal row patterns from the etree row walk
        (spec: symbolic/supernodes.py::supernodal_rows — same output
        contract, computed without the simplicial pattern)."""
        n = len(atp) - 1
        atp = np.ascontiguousarray(atp, np.int64)
        ati = np.ascontiguousarray(ati, np.int32)
        parent = np.ascontiguousarray(parent, np.int32)
        col2sup = np.ascontiguousarray(col2sup, np.int32)
        rptr = np.empty(nsuper + 1, dtype=np.int64)
        self._dll.pbt_supernodal_rows(n, atp, ati, parent, col2sup,
                                      nsuper, rptr,
                                      np.empty(0, dtype=np.int32), 0)
        rows = np.empty(int(rptr[-1]), dtype=np.int32)
        cursors = rptr[:-1].copy()
        full = np.concatenate([cursors, rptr[-1:]])
        self._dll.pbt_supernodal_rows(n, atp, ati, parent, col2sup,
                                      nsuper, full, rows, 1)
        return rptr, rows

    def nd_order(self, full, leaf_size: int = 48) -> np.ndarray:
        """Coordinate-free nested dissection over the full symmetric
        pattern (CSR); returns perm[new] = old (spec:
        symbolic/ordering.py::_graph_nd — same algorithm, native
        tie-breaks may differ; quality-tested, not bit-equal)."""
        m = full.tocsr()
        n = m.shape[0]
        perm = np.empty(n, dtype=np.int32)
        self._dll.pbt_nd_order(
            n, np.ascontiguousarray(m.indptr, np.int64),
            np.ascontiguousarray(m.indices, np.int32), int(leaf_size), perm)
        return perm

    def relaxed_amalgamation(self, sptr, sparent, width, nrows, zeros,
                             nrelax, zrelax, max_width):
        """Union-find merge pass; mutates sptr/width/nrows/zeros scratch
        arrays, returns the surviving-root mask (spec:
        symbolic/supernodes.py::relaxed_amalgamation)."""
        nsuper = len(sparent)
        is_root = np.empty(nsuper, dtype=np.uint8)
        self._dll.pbt_relaxed_amalgamation(
            nsuper, sptr, np.ascontiguousarray(sparent, np.int32),
            width, nrows, zeros,
            np.ascontiguousarray(nrelax, np.int64),
            np.ascontiguousarray(zrelax, np.float64),
            int(max_width), is_root)
        return is_root.astype(bool)

    def cholesky_updates(self, lptr, lind, total):
        n = len(lptr) - 1
        srca = np.empty(total, dtype=np.int32)
        srcb = np.empty(total, dtype=np.int32)
        dst = np.empty(total, dtype=np.int32)
        self._dll.pbt_cholesky_updates(
            n, np.ascontiguousarray(lptr, np.int64),
            np.ascontiguousarray(lind, np.int32), srca, srcb, dst)
        return srca, srcb, dst


def _source_tag() -> str:
    with open(_SRC, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:16]


def load() -> NativeLib:
    os.makedirs(_BUILD, exist_ok=True)
    name = f"libpbt_{_source_tag()}.so"
    so = os.path.join(_BUILD, name)
    if not os.path.exists(so):
        # processes that import the package at once (test workers) build
        # one at a time; the others find the library once the lock is
        # theirs
        with open(os.path.join(_BUILD, "build.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not os.path.exists(so):
                _compile(so)
                # stale builds of older source revisions are dead weight
                for f in os.listdir(_BUILD):
                    if (f.startswith("libpbt_") and f.endswith(".so")
                            and f != name):
                        try:
                            os.remove(os.path.join(_BUILD, f))
                        except OSError:
                            pass
    return NativeLib(ctypes.CDLL(so))


def _compile(so: str) -> None:
    """g++ into a temporary file beside ``so``, then rename it into place,
    so that no process ever loads a half-written library."""
    tmp = so + f".tmp{os.getpid()}"
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
             _SRC, "-o", tmp],
            check=True, capture_output=True)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
