"""Typed configuration for the whole pipeline.

The reference scatters configuration across positional CLI args and
compile-time ``#define``s (choleskyTest01.cpp:74-115, PB_Cholesky.h:10-14,
LSparsity.h:446-534).  Here it is one dataclass covering ordering,
amalgamation, scheduling, kernel tiling, dtype and sharding.

The port's own copy of ``parsy_bench_tpu/config.py`` (the reference); only
the package in its imports differs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    # ---- ordering (reference: LSparsity.h:446-621 GIVEN/SCOTCH/METIS/AMD) ----
    #: one of "natural", "amd", "nd" (coordinate-free BFS level-structure
    #: nested dissection), "nd-geo" (coordinate bisection; needs coords),
    #: "rcm", "given".
    ordering: str = "amd"
    #: permutation used when ordering == "given" (maps new -> old).
    given_perm: Optional[Sequence[int]] = None

    # ---- supernode amalgamation (reference: Inspection_BlockC.h:370-483) ----
    #: relaxed-amalgamation thresholds: merge child into parent when
    #: nchild_cols <= nrelax[0], or zeros-fraction <= zrelax[k] at size
    #: breakpoints nrelax[k] (CHOLMOD-style rule, choleskyTest01.cpp:111-112).
    #: Defaults are ~2x the reference's (4,16,48)/(0.8,0.1,0.05): on TPU
    #: extra explicit zeros ride the MXU for free while bigger panels cut
    #: update-lane and row-movement counts (measured +20% factorize
    #: throughput at n=1e5, scripts/scale_test.py r3).
    nrelax: Tuple[int, int, int] = (8, 32, 96)
    zrelax: Tuple[float, float, float] = (0.9, 0.2, 0.1)
    #: hard cap on supernode width; wider supernodes are split into panels of
    #: this width so every MXU tile class stays bounded.
    max_supernode_width: int = 128

    # ---- scheduling (replaces LBC, InspectionLevel_06.h:18) ----
    #: stored width classes for the per-class panel row pools (ascending).
    #: Few classes = few compiled batch-kernel shapes; narrow supernodes are
    #: zero-padded to the smallest class (TPU rows must be >= 32 lanes to
    #: gather at speed, scripts/microbench2.py).  Classes above 16 must be
    #: multiples of 16 (the blocked-Cholesky panel width, ops/dense.py).
    width_classes: Tuple[int, ...] = (32, 128)
    #: update-chunk row classes (descending, multiples of 8); each source
    #: chunk becomes one lane of a batched MXU einsum.
    chunk_classes: Tuple[int, ...] = (256, 64, 16)
    #: padded aligned-overlap-width classes (ascending, multiples of 8)
    #: for the update B operand; must cover max overlap + 7 alignment
    #: pre-rows (splan packed gathers).
    q_classes: Tuple[int, ...] = (16, 48, 136)
    #: how per-step update contributions land on the delta window:
    #: "gather" inverts the scatter at inspection time into static
    #: gathers + ladder sums + one dense take (scatter-free — ~25 ns per
    #: scattered row measured vs ~1 ns per taken row; splan
    #: _build_gather_tables); "scatter" keeps the index scatter-add.
    #: Single-shard plans only — sharded/distributed executors always
    #: scatter (their deltas ride collectives).
    update_delta: str = "gather"
    #: scan-segmentation padding tolerance: close a segment when padding
    #: every bucket to the running lane maxima would exceed this multiple
    #: of the true work (ops/simplicial.py segment_levels).
    segment_alpha: float = 1.25
    #: max (P * H * c) elements per finalize bucket — bigger buckets are
    #: split along the (pool-contiguous) lane axis so no single (P,H,c)
    #: temp exceeds ~128 MB f32 (the unsplit n=1e6 leaf bucket's 3.9 GB
    #: temps exceeded HBM; splits are invisible at n<=3e5 scales).
    fin_bucket_elems: int = 32 * 2**20
    #: slack-based level placement: delay supernodes below their update
    #: targets to flatten per-bucket lane histograms (reference slack
    #: freedom, InspectionLevel_06.h:118-132).  Cuts padded finalize
    #: lanes 76% at n=32k, but measured 12% SLOWER factorize on the real
    #: chip at n=1e5 (update-bucket peaks grow when sources move later,
    #: RESULTS_r04) — off by default, kept as a measured knob.
    slack_placement: bool = False
    #: dense trailing-solve block ("top"): the thin top levels of the
    #: etree (the root-separator panel chains — 42 of 64 levels at n=1e5
    #: hold <= 2 panels each) are collapsed into ONE dense
    #: triangular-inverse GEMV per solve, the MXU-native form of the
    #: reference's peeled last level (H2LeveledBlockedLsolve_Peeled,
    #: Triangular_BCSC.h:238: last level serial with multithreaded BLAS).
    #: Max columns absorbed (Tinv memory = cols^2 * 4 bytes); 0 disables.
    #: Measured on-chip at n=110k (r5): NEUTRAL once the merged per-class
    #: diagonal solve landed (21.9 ms off vs 22.4 ms at 4096 — the
    #: absorbed thin levels were already cheap, and the single-step
    #: mega-buckets pay the same update traffic the levels did); off by
    #: default at bench scale, revisited per-size by scripts/large_run.py.
    dense_top_cols: int = 0
    #: absorb a level range into the dense top only while its levels are
    #: thin (<= this many panels per level) — fat bottom levels solve
    #: faster leveled than dense.
    dense_top_thin: int = 8
    #: blocked-trisolve aligned-operand pool budget (MB): solve_prep
    #: precomputes each update pair's column-aligned overlap block
    #: G = S @ B_raw once per factorization, so every solve step is one
    #: contiguous slab read + one batched (c,K)@(K,) einsum + one row
    #: scatter per bucket.  Measured on-chip at n=110k (r5): 2x SLOWER
    #: than the on-the-fly one-hot alignment (42.5 vs 21.9 ms) — XLA
    #: lowers the slab-fed batched matvec worse than the fused
    #: gather+matmul chain it replaces — so 0 (disabled) by default;
    #: kept as a measured knob.  0 = always align on the fly.
    solve_gpool_mb: int = 0
    #: general-DAG trisolve schedule: "wavefront" (one batched step per
    #: level, H1), "coarsened" (dense W-column window steps, the DAG-LBC
    #: replacement — symbolic/dagplan.py), or "auto" (cost-model pick).
    trisolve_schedule: str = "auto"
    #: window width of the coarsened trisolve schedule.
    coarse_width: int = 256
    #: height granularity of panel padding (f32 sublane tile is 8).
    height_unit: int = 8

    # ---- executor tier ----
    #: "simplicial" (scalar level-scheduled, any pattern) or "supernodal"
    #: (blocked BCSC panels, batched MXU kernels — the performance tier,
    #: reference cholesky_left_par_05).
    tier: str = "simplicial"

    # ---- numerics ----
    #: dtype of the numeric phase ("float32" on TPU; "float64" runs on CPU).
    dtype: str = "float32"
    #: iterative-refinement sweeps applied after triangular solves to recover
    #: accuracy lost to f32 (the reference is f64 end-to-end).
    refine_steps: int = 0

    # ---- distribution ----
    #: number of devices along the partition ("w-partition owner") mesh axis.
    num_partitions: int = 1

    # ---- instrumentation ----
    verify: bool = False
    profile: bool = False

    def replace(self, **kw) -> "SolverConfig":
        return dataclasses.replace(self, **kw)
