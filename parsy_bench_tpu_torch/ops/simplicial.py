"""Level segmentation shared by the supernodal inspector (numpy only).

Counterpart of ``parsy_bench_tpu/ops/simplicial.py``.  Only
``segment_levels`` lives here for now: the supernodal plan
(``parsy_bench_tpu_torch/symbolic/splan.py``) needs it, and the JAX module
cannot be imported without jax.  The level-scheduled ``SimplicialExecutor``
joins this module when the simplicial tier is ported.
"""
from __future__ import annotations

import numpy as np

#: close a scan segment when padding would exceed this multiple of true work
_PAD_ALPHA = 1.25
#: fixed per-level slack so tiny neighbouring levels coalesce freely
_PAD_SLACK = 64.0


def segment_levels(counts: np.ndarray, alpha: float = _PAD_ALPHA,
                   slack: float = _PAD_SLACK) -> list[tuple[int, int]]:
    """Split the level sequence into contiguous runs [(t0, t1), ...).

    ``counts`` is (nlev, k) per-level work sizes.  A run is closed when
    padding everything in it to the running maxima would exceed
    ``_PAD_ALPHA * true + _PAD_SLACK * len`` — wavefront level sizes decay
    roughly monotonically, so runs coalesce the long tail of tiny levels.
    """
    counts = np.atleast_2d(np.asarray(counts, dtype=np.float64))
    nlev = counts.shape[0]
    segs: list[tuple[int, int]] = []
    t0 = 0
    while t0 < nlev:
        t1 = t0 + 1
        run_max = counts[t0].copy()
        run_sum = float(counts[t0].sum())
        while t1 < nlev:
            new_max = np.maximum(run_max, counts[t1])
            new_sum = run_sum + float(counts[t1].sum())
            padded = float(new_max.sum()) * (t1 - t0 + 1)
            if padded > alpha * new_sum + slack * (t1 - t0 + 1):
                break
            run_max, run_sum = new_max, new_sum
            t1 += 1
        segs.append((t0, t1))
        t0 = t1
    return segs
