"""Matrix / ordering file IO.

MatrixMarket coordinate IO with the same storage contract as the reference
(common/Util.h:77 ``readMatrix``: lower-half of a symmetric matrix), plus the
PaStiX-style ordering-file reader (common/Util.h:187 ``readOrdering``) that
makes the symbolic phase cacheable-by-contract, and schedule (de)serialization
— the new framework's checkpointable artifact (SURVEY §5.4).

The port's own copy of ``parsy_bench_tpu/core/io.py`` (the reference); only
the package in its imports differs.
"""
from __future__ import annotations

import io as _io
import json
import os
import pickle
from typing import Optional

import numpy as np
import scipy.io as sio
import scipy.sparse as sp

from parsy_bench_tpu_torch.core.csc import CSC


def read_matrix_market(path: str, lower: bool = True) -> CSC:
    """Read a MatrixMarket file into CSC.

    ``lower=True`` keeps only the lower half (i >= j) — symmetric ``.mtx``
    files from SuiteSparse already store exactly that, and general files are
    projected, matching the reference driver input contract.
    """
    m = sio.mmread(path).tocsc()
    if lower:
        m = sp.tril(m, 0).tocsc()
    m.sum_duplicates()
    m.sort_indices()
    return CSC.from_scipy(m)


def write_matrix_market(path: str, a: CSC, symmetric: bool = True) -> None:
    """Write lower-half CSC as a symmetric MatrixMarket file (the inverse of
    ``read_matrix_market``; reference: MakingLowerHalf.cpp:9 emits the same
    format)."""
    sio.mmwrite(path, a.to_scipy(), symmetry="symmetric" if symmetric else "general")


def read_ordering(path: str, n: int) -> np.ndarray:
    """Ordering-file reader (reference: common/Util.h:187 ``readOrdering``).

    Accepts the reference/PaStiX format — '%' comment lines, a header line
    whose first token is n, then **one permutation value per line** read
    sequentially into perm[0..n) — and, as a fallback, this repo's older
    ``i perm[i]`` pair format (two tokens per line).
    """
    with open(path) as f:
        lines = [ln.split() for ln in f
                 if ln.strip() and not ln.lstrip().startswith("%")]
    count = int(lines[0][0])
    if count != n:
        raise ValueError(f"ordering file is for n={count}, matrix has n={n}")
    body = lines[1:]
    if len(body) < n:
        raise ValueError(f"ordering file has {len(body)} entries, need {n}")
    perm = np.empty(n, dtype=np.int64)
    if all(len(tok) >= 2 for tok in body[:n]):
        for tok in body[:n]:               # pair format: i perm[i]
            perm[int(tok[0])] = int(tok[1])
    else:
        for i, tok in enumerate(body[:n]):  # reference format: one per line
            perm[i] = int(tok[0])
    if not np.array_equal(np.sort(perm), np.arange(n)):
        raise ValueError("ordering file is not a permutation of 0..n-1")
    return perm


def write_ordering(path: str, perm: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write(f"{len(perm)} 0\n")
        for i, p in enumerate(np.asarray(perm)):
            f.write(f"{i} {int(p)}\n")


# --------------------------------------------------------------------------
# Symbolic-artifact checkpointing: the inspector output (permutation,
# supernode partition, schedule index arrays) is the expensive, reusable part
# of a solve — serialize it once per sparsity pattern.
# --------------------------------------------------------------------------

#: Bump whenever the pickled plan/layout schema changes shape (e.g. the
#: round-5 _LazyPattern structure-only slim-down): loading an artifact
#: written under an INCOMPATIBLE version fails with a clear re-analyze
#: message instead of an opaque attribute error deep inside the executor.
ARTIFACT_FORMAT = 4

#: Formats this build can still read.  Schema changes that stay
#: load-compatible extend this set instead of orphaning old artifacts.
COMPATIBLE_FORMATS = frozenset({ARTIFACT_FORMAT})


def save_artifact(path: str, obj, meta: Optional[dict] = None) -> None:
    meta = dict(meta or {})
    meta.setdefault("format", ARTIFACT_FORMAT)
    payload = {"meta": meta, "obj": obj}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


class _PortUnpickler(pickle.Unpickler):
    """Unpickles an artifact without importing the JAX package: a class of
    ``parsy_bench_tpu`` (not of ``parsy_bench_tpu_torch``) is refused."""

    def find_class(self, module, name):
        top = module.split(".")[0]
        if top == "parsy_bench_tpu":
            raise ValueError(
                f"analysis artifact holds {module}.{name}: it was written "
                f"by the JAX package (parsy_bench_tpu); re-run the analysis "
                f"with the port (parsy_bench_tpu_torch CholeskySolver(...)"
                f".save_analysis) to regenerate it")
        return super().find_class(module, name)


def load_artifact(path: str):
    """(obj, meta) of an artifact ``save_artifact`` wrote.  It is unpickled
    (load only artifacts this program wrote); one written by the JAX
    package raises ``ValueError`` before anything of that package is
    imported."""
    with open(path, "rb") as f:
        payload = _PortUnpickler(f).load()
    fmt = payload["meta"].get("format", 0)
    if fmt not in COMPATIBLE_FORMATS:
        raise ValueError(
            f"analysis artifact {path!r} has format {fmt}, this build reads "
            f"formats {sorted(COMPATIBLE_FORMATS)} — re-run the analysis "
            f"(CholeskySolver(...).save_analysis) to regenerate it")
    return payload["obj"], payload["meta"]
