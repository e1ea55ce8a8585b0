"""Supernode detection, relaxed amalgamation, and the BCSC factor layout.

Reference: cholesky/Inspection_BlockC.h ``super_symbolic2`` — fundamental
supernodes from the postordered etree + column counts (:315-328), supernodal
etree (:353), CHOLMOD-style relaxed amalgamation with (nrelax, zrelax)
(:370-483), and the supernodal row pattern Ls (:684-752).

TPU-first differences from the reference:

* supernodes wider than ``max_width`` are **split into panel chains** so
  every stored panel fits one MXU-width class — the huge root separator
  becomes a chain of 128-column panels whose mutual updates are dense
  GEMMs, subsuming the reference's "last level with multithreaded BLAS"
  (parallel_PB_Cholesky_05.h:271) by construction;
* panels are stored **row-major padded** to (height rounded to 8, width
  rounded to a class in ``width_classes``) in one flat pool, so numeric
  updates are contiguous slices and zero padding participates harmlessly
  in GEMMs.

The port's own copy of ``parsy_bench_tpu/symbolic/supernodes.py`` (the
reference); only the package in its imports differs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from parsy_bench_tpu_torch.core.csc import CSC, IDX
from parsy_bench_tpu_torch.native import lib as _native


@dataclasses.dataclass
class SupernodePartition:
    """Column partition into supernodes (before layout)."""
    nsuper: int
    sptr: np.ndarray      # (nsuper+1,) first column of each supernode
    col2sup: np.ndarray   # (n,) supernode of each column
    sparent: np.ndarray   # (nsuper,) supernodal etree (-1 = root)

    @property
    def widths(self) -> np.ndarray:
        return np.diff(self.sptr)


def fundamental_supernodes(parent: np.ndarray, cc: np.ndarray) -> np.ndarray:
    """Start flags of fundamental supernodes.

    Column j extends the supernode of j-1 iff parent[j-1] == j,
    cc[j-1] == cc[j] + 1, and j has exactly one child in the etree
    (the CHOLMOD rule, reference Inspection_BlockC.h:315-328).  Requires a
    postordered etree (supernode columns must be contiguous).
    """
    n = len(parent)
    nchild = np.zeros(n + 1, dtype=np.int64)
    np.add.at(nchild, parent, 1)  # parent == -1 accumulates at [-1]
    start = np.ones(n, dtype=bool)
    j = np.arange(1, n)
    merge = (parent[j - 1] == j) & (cc[j - 1] == cc[j] + 1) & (nchild[j] == 1)
    start[1:] = ~merge
    return start


def _supernodes_from_starts(start: np.ndarray,
                            parent: np.ndarray) -> SupernodePartition:
    n = len(start)
    sptr = np.concatenate([np.nonzero(start)[0], [n]]).astype(np.int64)
    nsuper = len(sptr) - 1
    col2sup = np.cumsum(start) - 1
    last = sptr[1:] - 1
    pcol = parent[last]
    sparent = np.where(pcol >= 0, col2sup[np.clip(pcol, 0, n - 1)], -1)
    return SupernodePartition(nsuper, sptr,
                              col2sup.astype(IDX), sparent.astype(IDX))


def relaxed_amalgamation(parent: np.ndarray, cc: np.ndarray,
                         start: np.ndarray,
                         nrelax=(4, 16, 48),
                         zrelax=(0.8, 0.1, 0.05),
                         max_width: int = 128) -> np.ndarray:
    """Merge small supernodes into their parents when the induced explicit
    zeros stay below the CHOLMOD thresholds.

    Rule (reference Inspection_BlockC.h:466-469): merge child c into parent
    p (both become one supernode spanning their columns; only valid when
    c's columns are exactly adjacent to p's) when the merged width w
    satisfies w <= nrelax[0], or the fraction of explicit zeros z in the
    merged panel is <= zrelax[k] for the applicable size bracket.

    Works bottom-up over the (postordered) column order; returns new start
    flags.  ``cc`` lets us track per-supernode nonzeros exactly:
    zeros(s) = nrows(s) * width(s) - sum(cc[j] + (j - j1) for j in s)
    where nrows(s) = cc[j1] + 0 ... we track nrows = cc[first col] + width-1
    under the subset property.
    """
    n = len(parent)
    part = _supernodes_from_starts(start, parent)
    sptr, sparent = part.sptr, part.sparent
    nsuper = part.nsuper

    # per supernode: width, rows below = cc[first] (incl. diagonal of first)
    width = np.diff(sptr).astype(np.int64)
    # number of rows of the supernode panel (= pattern of its first column)
    nrows = cc[sptr[:-1]].astype(np.int64)
    # explicit zeros currently in the panel:
    # nrows*w - sum_{k=0..w-1}(cc[j1+k] + k), vectorized via a cc cumsum
    cs = np.concatenate([[0], np.cumsum(cc, dtype=np.int64)])
    zeros = (nrows * width - (cs[sptr[1:]] - cs[sptr[:-1]]
                              + width * (width - 1) // 2)
             ).astype(np.float64)
    first_col = sptr[:-1].copy()   # start columns never mutate below

    if _native is not None:
        is_root = _native.relaxed_amalgamation(
            sptr.copy().astype(np.int64), sparent, width.copy(),
            nrows.copy(), zeros.copy(), nrelax, zrelax, max_width)
        new_start = np.zeros(n, dtype=bool)
        new_start[first_col[is_root]] = True
        new_start[0] = True
        return new_start

    merged_into = np.arange(nsuper)  # union-find to the surviving root

    def find(s):
        while merged_into[s] != s:
            merged_into[s] = merged_into[merged_into[s]]
            s = merged_into[s]
        return s

    # bottom-up: children have smaller indices than parents (postorder)
    for s in range(nsuper - 1):
        p = sparent[s]
        if p < 0:
            continue
        rs, rp = find(s), find(p)
        if rs == rp:
            continue
        # adjacency: child's columns must end where parent's begin
        if sptr[rs + 1] != sptr[rp]:
            continue
        w = width[rs] + width[rp]
        if w > max_width:
            continue
        # merged panel: parent's rows become child's tail rows; child keeps
        # its own rows.  nrows(merged) = nrows(child) + (rows of parent not
        # already in child's pattern).  Under the subset property the
        # parent's rows are a subset of the child's below-diagonal rows
        # union parent's columns, so nrows(merged) = max(nrows[rs],
        # width[rs] + nrows[rp]).
        nr = max(nrows[rs], width[rs] + nrows[rp])
        total = nr * w - (w * (w - 1)) // 2
        filled = (nrows[rs] * width[rs] - (width[rs] * (width[rs] - 1)) // 2
                  - zeros[rs]) + (nrows[rp] * width[rp]
                                  - (width[rp] * (width[rp] - 1)) // 2
                                  - zeros[rp])
        z = 1.0 - filled / max(total, 1)
        ok = (w <= nrelax[0]
              or (w <= nrelax[1] and z <= zrelax[0])
              or (w <= nrelax[2] and z <= zrelax[1])
              or z <= zrelax[2])
        if not ok:
            continue
        # merge rs into rp, surviving root keeps child's first column
        merged_into[rp] = rs
        sptr_rs1 = sptr[rp + 1]  # merged supernode now spans to parent end
        width[rs] = w
        nrows[rs] = nr
        zeros[rs] = total - filled
        # extend: record by rewriting sptr of the surviving root's end
        sptr[rs + 1] = sptr_rs1  # note: only roots' entries are read below

    new_start = np.zeros(n, dtype=bool)
    for s in range(nsuper):
        if find(s) == s:
            new_start[sptr[s]] = True
    new_start[0] = True
    return new_start


def split_wide(start: np.ndarray, max_width: int) -> np.ndarray:
    """Split supernodes wider than ``max_width`` into panel chains."""
    n = len(start)
    starts = np.nonzero(start)[0]
    ends = np.concatenate([starts[1:], [n]])
    out = start.copy()
    for j1, j2 in zip(starts, ends):
        w = j2 - j1
        if w > max_width:
            out[j1 + max_width:j2:max_width] = True
    return out


def build_partition(a: CSC, parent: np.ndarray, cc: np.ndarray,
                    nrelax=(4, 16, 48), zrelax=(0.8, 0.1, 0.05),
                    max_width: int = 128) -> SupernodePartition:
    """Full pipeline: fundamental SNs -> relaxed amalgamation -> width split.

    ``a`` must already be permuted by (fill-reducing ∘ postorder), so the
    etree is topologically ordered with contiguous children.
    """
    start = fundamental_supernodes(parent, cc)
    start = relaxed_amalgamation(parent, cc, start, nrelax, zrelax, max_width)
    start = split_wide(start, max_width)
    return _supernodes_from_starts(start, parent)


# --------------------------------------------------------------- layout

@dataclasses.dataclass
class ClassLayout:
    """Width-class panel-pool layout of the supernodal factor (v2).

    One 2-D row pool per stored width class c: ``pool_c`` has shape
    (nrows[ci], c) float32; supernode s of class ``cls[s]`` occupies rows
    [rowoff[s], rowoff[s] + hpad[s]) of its class pool, row r of the panel
    holding L[rows[rptr[s]+r], sptr[s]+k] at column k.  Panels are laid out
    level-major and, within a level, sorted by height class, so

    * each level's class-c panels form one contiguous row window
      [rlo[ci][lev], rlo[ci][lev] + wrows[ci][lev]) — the executor's
      update target and finalize slice;
    * each (height-class) finalize bucket is a contiguous sub-slice.

    The reference stores the same factor as column-major unpadded BCSC
    (common/def.h:117); the row-pool form exists because TPU data movement
    is only fast at row granularity (scripts/microbench2.py).
    """
    part: SupernodePartition
    n: int                    # matrix dimension
    classes: tuple            # stored width classes, ascending
    rptr: np.ndarray          # (nsuper+1,) row-pattern offsets
    rows: np.ndarray          # (sum h,) global row ids, ascending per panel
    cls: np.ndarray           # (nsuper,) class index
    wpad: np.ndarray          # (nsuper,) stored width  = classes[cls]
    hpad: np.ndarray          # (nsuper,) stored rows (height class >= wpad)
    rowoff: np.ndarray        # (nsuper,) int64 first row in the class pool
    nrows: np.ndarray         # (ncls,) pool rows incl. slack + dummy row
    lev: np.ndarray           # (nsuper,) wavefront level
    rlo: np.ndarray           # (ncls, nlev) window start row
    wrows: np.ndarray         # (ncls, nlev) true window rows
    a_map: list               # per class: (2, k) [flat pool pos; a-data idx]
    lpat: object              # simplicial L pattern: sp.csc_matrix OR a
    #                           zero-arg picklable callable producing one
    #                           (lazy — verification paths only)
    nnz_l: int                # nnz of the simplicial pattern
    _l_map_cache: list | None = None

    @property
    def ncls(self) -> int:
        return len(self.classes)

    def lpat_matrix(self) -> sp.csc_matrix:
        """The simplicial L pattern, materializing it on first use (it
        is nnz(L)-sized and only verification paths need it)."""
        if callable(self.lpat):
            self.lpat = self.lpat()
        return self.lpat

    @property
    def l_map(self) -> list:
        """Per class (2, k) [flat pool pos; l-nnz idx] extraction map of
        the simplicial L pattern.  Computed lazily: it is nnz(L)-sized
        (tens of millions of entries at reference scale) and only the
        verification path (factor_values) reads it — eager computation
        used to dominate the whole plan emission."""
        if self._l_map_cache is None:
            lpat = self.lpat_matrix()
            lptr = lpat.indptr.astype(np.int64)
            n = lpat.shape[0]
            lcol = np.repeat(np.arange(n, dtype=np.int64), np.diff(lptr))
            lc, lflat = _entry_positions(
                self, lpat.indices.astype(np.int64), lcol)
            self._l_map_cache = [
                np.stack([lflat[lc == ci], np.nonzero(lc == ci)[0]])
                for ci in range(self.ncls)]
        return self._l_map_cache

    def pool_elems(self) -> int:
        return int(sum(int(r) * c for r, c in zip(self.nrows, self.classes)))


def _entry_positions(lay: "ClassLayout", i: np.ndarray,
                     j: np.ndarray) -> tuple:
    """(class, flat pool position) of entries L[i, j] (i >= j, int64)."""
    part = lay.part
    n = lay.n
    nsuper = part.nsuper
    sup_of_row = np.repeat(np.arange(nsuper, dtype=np.int64),
                           np.diff(lay.rptr))
    row_keys = sup_of_row * np.int64(n + 1) + lay.rows.astype(np.int64)
    col2sup64 = part.col2sup.astype(np.int64)
    s = col2sup64[j]
    r = np.searchsorted(row_keys, s * np.int64(n + 1) + i)
    assert np.all(lay.rows[r] == i), "entry outside supernodal pattern"
    flat = (lay.rowoff[s] * lay.wpad[s] + (r - lay.rptr[s]) * lay.wpad[s]
            + (j - part.sptr[s]))
    return lay.cls[s], flat


def _height_class(h: np.ndarray, base: np.ndarray) -> np.ndarray:
    """Smallest base * 2^k >= h (vectorized ladder)."""
    h8 = np.maximum(-(-h // 8) * 8, base)
    k = np.ceil(np.log2(np.maximum(h8 / base, 1.0) - 1e-12))
    return (base * np.power(2.0, np.maximum(k, 0))).astype(np.int64)


class _LazyPattern:
    """Picklable thunk producing the simplicial L pattern on demand, so
    inspector artifacts stay self-contained without materializing the
    nnz(L)-sized pattern (verification paths only).  Only the sparsity
    STRUCTURE of A is kept — symbolic_pattern never reads values, and
    embedding them would bake a stale copy of the numeric data into every
    saved analysis artifact."""

    def __init__(self, a: CSC, parent: np.ndarray):
        self.n = a.n
        self.indptr = a.indptr
        self.indices = a.indices
        self.parent = parent

    def __call__(self) -> sp.csc_matrix:
        from parsy_bench_tpu_torch.symbolic.colcounts import (
            symbolic_pattern)
        a = CSC(self.n, self.indptr, self.indices,
                np.ones(len(self.indices), dtype=np.int8))
        return symbolic_pattern(a, self.parent)


def supernodal_rows_from_etree(a: CSC, parent: np.ndarray,
                               part: SupernodePartition) -> tuple:
    """(rptr, rows) via the native etree row walk — the reference's
    row-subtree Ls construction (Inspection_BlockC.h:684-752) without
    materializing the simplicial pattern.  Requires the native library;
    callers fall back to :func:`supernodal_rows`."""
    at = a.to_scipy().T.tocsc()  # row view of lower(A)
    rptr, rows = _native.supernodal_rows(
        at.indptr.astype(np.int64), at.indices.astype(np.int32),
        parent.astype(np.int32), part.col2sup.astype(np.int32),
        part.nsuper)
    widths = np.diff(part.sptr)
    assert np.all(np.diff(rptr) >= widths), "diag rows missing from pattern"
    return rptr.astype(np.int64), rows.astype(IDX)


def supernodal_rows(lpat: sp.csc_matrix,
                    part: SupernodePartition) -> tuple:
    """(rptr, rows): union of the simplicial column patterns per supernode
    (the reference builds the same Ls by row-subtree walks,
    Inspection_BlockC.h:684-752).  Vectorized as one sparse matmul."""
    n = lpat.shape[0]
    sel = sp.csc_matrix(
        (np.ones(n, dtype=np.int8), part.col2sup,
         np.arange(n + 1, dtype=np.int64)),
        shape=(part.nsuper, n)).T  # (n, nsuper) column j -> supernode
    u = (lpat @ sel).tocsc()
    u.sort_indices()
    rptr = u.indptr.astype(np.int64)
    rows = u.indices.astype(IDX)
    # amalgamation guarantee: the diag-block rows j1..j2-1 are all present
    widths = np.diff(part.sptr)
    assert np.all(np.diff(rptr) >= widths), "diag rows missing from pattern"
    return rptr, rows


def build_class_layout(lpat, a: CSC,
                       part: SupernodePartition, lev: np.ndarray,
                       classes=(32, 128), parent: np.ndarray | None = None,
                       nnz_l: int | None = None,
                       rptr: np.ndarray | None = None,
                       rows: np.ndarray | None = None) -> ClassLayout:
    """Level-major per-class row-pool layout (see ClassLayout).

    ``lpat`` may be None when ``parent`` and ``nnz_l`` are given: the
    supernodal row patterns then come from the native etree row walk and
    the simplicial pattern stays lazy (computed only if a verification
    path asks for it).  Precomputed (rptr, rows) skip that step."""
    n = a.n
    sptr, nsuper = part.sptr, part.nsuper
    classes = tuple(sorted(classes))
    if rptr is None:
        if lpat is None:
            if parent is None or nnz_l is None:
                raise ValueError("lpat=None requires parent and nnz_l")
            if _native is not None and hasattr(_native, "supernodal_rows"):
                rptr, rows = supernodal_rows_from_etree(a, parent, part)
            else:
                from parsy_bench_tpu_torch.symbolic.colcounts import (
                    symbolic_pattern)
                lpat = symbolic_pattern(a, parent)
                rptr, rows = supernodal_rows(lpat, part)
        else:
            rptr, rows = supernodal_rows(lpat, part)
    lpat_store = lpat if lpat is not None else _LazyPattern(a, parent)
    nnz_l = int(lpat.nnz) if lpat is not None else int(nnz_l)
    h = np.diff(rptr)
    w = np.diff(sptr)
    cls = np.searchsorted(np.asarray(classes), w)
    if cls.max(initial=0) >= len(classes):
        raise ValueError(f"width {w.max()} exceeds largest class")
    wpad = np.asarray(classes)[cls].astype(np.int64)
    hpad = _height_class(h, wpad)

    nlev = int(lev.max(initial=-1)) + 1
    ncls = len(classes)
    rowoff = np.zeros(nsuper, dtype=np.int64)
    rlo = np.zeros((ncls, nlev), dtype=np.int64)
    wrows = np.zeros((ncls, nlev), dtype=np.int64)
    nrows = np.zeros(ncls, dtype=np.int64)
    for ci in range(ncls):
        sel = np.nonzero(cls == ci)[0]
        order = sel[np.lexsort((sel, hpad[sel], lev[sel]))]
        sizes = hpad[order]
        offs = np.concatenate([[0], np.cumsum(sizes)])
        rowoff[order] = offs[:-1]
        total = int(offs[-1])
        # per-level window bounds: `order` is sorted by level, so each
        # level is one contiguous run of panels
        lv = lev[order]
        lo_i = np.searchsorted(lv, np.arange(nlev))
        hi_i = np.searchsorted(lv, np.arange(nlev) + 1)
        nonempty = hi_i > lo_i
        rlo[ci] = offs[np.minimum(lo_i, len(offs) - 1)]
        wrows[ci] = np.where(nonempty,
                             offs[np.minimum(hi_i, len(offs) - 1)]
                             - rlo[ci], 0)
        nrows[ci] = total  # slack added by the plan builder

    lay = ClassLayout(part=part, n=n, classes=classes, rptr=rptr, rows=rows,
                      cls=cls, wpad=wpad, hpad=hpad, rowoff=rowoff,
                      nrows=nrows, lev=lev, rlo=rlo, wrows=wrows,
                      a_map=[], lpat=lpat_store, nnz_l=nnz_l)
    acol = np.repeat(np.arange(n, dtype=np.int64), np.diff(a.indptr))
    ac, aflat = _entry_positions(lay, a.indices.astype(np.int64), acol)
    lay.a_map = [np.stack([aflat[ac == ci],
                           np.nonzero(ac == ci)[0]]) for ci in range(ncls)]
    return lay
