"""Fit ``ChipModel``'s constants on the card from per-segment device times
of a real plan: the port's counterpart of ``collect`` and ``fit`` in
``scripts/calibrate_model.py``.

The observations are ``SupernodalExecutor.profile_segments`` times (each
segment's captured program run from its restored input, back to back,
timed with CUDA events on the card, the restore's time subtracted; the
JAX script's runs go on from their own output, NaN after a few), the
features are ``perfmodel.segment_features``, and the fit
is the same column-scaled non-negative least squares with the same folded
columns: the finalize's flops, bytes and lanes share the update's rates.

    rows = collect(solver)         # CholeskySolver(tier="supernodal")
    fitted = fit(rows)             # ChipModel fields, _fit_r2, _residual_s
"""
from __future__ import annotations

import numpy as np

from parsy_bench_tpu_torch.utils.perfmodel import segment_features

#: fitted columns, in ``fit``'s order; a rate (cost = feature / rate) for
#: the names in ``INVERSE``, a cost per unit of the feature otherwise
COLUMNS = ("step_s", "stream_bytes", "upd_bucket_s", "lane_s", "mxu_flops",
           "gather_rows", "scatter_rows", "fin_bucket_s", "chain_op_s")
INVERSE = frozenset({"stream_bytes", "mxu_flops", "gather_rows",
                     "scatter_rows"})


def collect(solver, iters: int = 3, reps: int = 20) -> list[dict]:
    """One row per segment of ``solver.plan``: its ``segment_features``
    and its ``median_s`` from ``solver.executor.profile_segments`` on the
    solver's own A values."""
    prof = solver.executor.profile_segments(solver.ap.data, iters, reps)
    rows = []
    for seg, p in zip(solver.plan.segments, prof):
        f = segment_features(seg, solver.plan.classes)
        f["median_s"] = p["median_s"]
        rows.append(f)
    return rows


def _design(rows):
    """The (segments, COLUMNS) feature matrix, shared columns folded."""
    A = np.zeros((len(rows), len(COLUMNS)))
    for i, r in enumerate(rows):
        A[i] = (r["steps"], r["wbytes"] + r["fin_bytes"], r["upd_buckets"],
                r["upd_lanes"] + r["fin_lanes"],
                r["upd_flops"] + r["fin_flops"], r["grows"], r["srows"],
                r["fin_buckets"], r["chain_cols"])
    return A


def fit(rows) -> dict:
    """Non-negative least squares of the segments' ``median_s`` on their
    features, columns scaled to their largest entry: the ``ChipModel``
    fields (a rate fitted at zero cost is ``inf``), plus ``_fit_r2`` and
    the root-mean-square residual ``_residual_s``."""
    from scipy.optimize import nnls
    A = _design(rows)
    y = np.array([r["median_s"] for r in rows])
    scale = np.maximum(A.max(axis=0), 1e-30)
    x, _ = nnls(A / scale, y)
    coef = x / scale
    fitted = {}
    for c, v in zip(COLUMNS, coef):
        if c in INVERSE:
            fitted[c] = 1.0 / v if v > 0 else np.inf
        else:
            fitted[c] = float(v)
    pred = A @ coef
    fitted["_fit_r2"] = float(1 - np.sum((pred - y) ** 2)
                              / max(np.sum((y - y.mean()) ** 2), 1e-30))
    fitted["_residual_s"] = float(np.sqrt(np.mean((pred - y) ** 2)))
    return fitted
