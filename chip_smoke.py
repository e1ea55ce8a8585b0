#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``parsy_bench_tpu_torch``) on one
NVIDIA GPU:

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 off for matmuls and cuDNN, float32 matmul precision
   "highest".  Exits 2 without a result when CUDA is not available;
2. build: compiles the CUDA kernels from ``parsy_bench_tpu_torch/csrc``
   (one nvcc per source, all at once) and loads them; reports whether the
   port's native inspector library (``parsy_bench_tpu_torch/native``, g++
   at first import) loaded (without it analyze falls back to numpy);
3. K1, the batched Cholesky + inverse kernel, against its plain PyTorch
   version on the card, f32, at the main path's batch shapes (P, c) =
   (27,520, 32), (87, 128), (2,215, 32), (2, 128) and (1, 128) (checked
   against the plan in phase 4), at P = 6 for c = 8, 16, 48, 64, 96 and
   112, and in f64 at (64, 32) and (8, 128): L within 1e-5*c, Linv within
   1e-5 (f64: 1e-10*c and 1e-10), padded (w = 0) lanes exactly identity,
   ||L L^T - D||/||D|| < 1e-5 and ||Linv L - I|| < 1e-4 per block, NaN
   from a negative pivot at c = 16, 32, 48 and 128.  Each shape is timed
   with CUDA events beside the plain version and the library pair
   ``cholesky_ex`` + ``solve_triangular``, with its bound (bytes over
   3.35 TB/s or FLOPs over 67 TFLOP/s) and its share of the bound;
4. main path: ``CholeskySolver`` on ``laplace_3d(48)`` (n = 110,592),
   nested dissection, f32, supernodal tier, on the card: analyze, one
   first and five timed ``factorize`` calls (the first captures the
   executor's ``factorize`` program, the others replay it).  With every
   launch count at 0 before: K1 counted twice the plan's ``chol_inverse``
   calls (the warm-up's launches and the capture's), the capture alone
   once, and the replays none; one more (replayed) factorize under
   ``torch.profiler`` gives the device operations, the device-busy ms, the
   device span and idle share and K1's launches and device ms by kernel
   name (a profile with no device time raises); peak allocated and
   reserved memory after the capture; gates: with b = L*1,
   ``solve_lower`` (the pair-granular fast solve) gives max|1 - x| < 1e-3,
   and ``solve(A*1)`` gives ||A x - b|| / ||b|| < 1e-3;
5. the captured programs at n = 110,592: ``factorize_segmented`` at
   ``group`` = 8 and 16 (capture seconds, nodes and K1's launches per
   replay of each program set, which sum to the plan's calls), their
   pools and those of ``factorize`` (A's values from numpy and from a
   device tensor) equal to ``_factorize_eager``'s bit for bit (or within
   1e-6 of the pool scale, flagged); aliasing: a second factorize with A
   scaled by 2 leaves the first pools as they were, and ``solve_lower``
   with b = L*1 passes on each factor, taken in turns; in ABBA turns the
   captured ``factorize`` against ``_factorize_eager`` (five each), the
   fast ``solve_lower`` program against its eager loop; ``factorize_loop``
   and ``solve_loop`` (5 iterations) per iteration; the clone of the pools
   timed alone; the eager factorize's device busy from ``torch.profiler``;
   ``profile_segments`` once, its sum against one factorize;
6. factor residual ||L L^T - A|| / ||A|| < 1e-3 at ``laplace_3d(24)``
   (n = 13,824; the host-side scipy product at n = 110,592 takes minutes);
7. K2, the fused finalize kernel, against its plain version on the card
   at the fused path's bucket shapes (27,456 x 32 x 32, 640 x 128 x 32,
   1 x 4,096 x 32, checked against the plan) and at 64 x 128 x 128, f32:
   diff within 1e-5*c of the largest |entry|, w = 0 lanes, lanes at or
   beyond cnt exactly zero, NaN from a negative pivot; the leaf once more
   at its widths and cnt in the plan (most of its lanes are one column
   wide), and f64 at 64 x 70 x 32 and 8 x 160 x 64 (bar 1e-10*c); both
   versions timed with CUDA events, with the bound of each shape; at the
   two tall shapes also the kernel's time at other row-chunk counts than
   the wrapper's (``ops/kernels.finalize_chunks``);
8. the fused configuration at n = 110,592: a second executor on the same
   plan with ``fused_finalize=True``; one first call (the capture), then
   five fused and five default ``factorize`` calls in turns (ABBA), with
   the counts at 0 before: K2 counted twice ``fused_calls_per_factorize``
   and K1 twice ``chol_calls_per_factorize`` (warm-up and capture), the
   capture alone once each, the replays none; the fused pools equal the
   fused ``_factorize_eager``'s and agree with the default pools within
   1e-3 of the pool scale; gates as in phase 4 on the fused factor,
   and the factor residual < 1e-3 at ``laplace_3d(24)`` with
   ``fused_finalize=True``; the device operations and device time of one
   fused and one default factorize, and K2's launches and device ms in
   the fused one by kernel name, from ``torch.profiler``;
9. the forward solves, op by op: ``_linv_pools`` timed once, the fast
   ``_solve_lower_fast_impl`` and the leveled ``_solve_lower_impl`` timed
   in turns, each with the b = L*1 gate, and the device operations of
   each counted with ``torch.profiler``;
10. the probes (``parsy_bench_tpu_torch.probes.run``): P1 copy bit-equal,
   P2 matmul within 1e-5*K*max|a|*max|b| of a float64 product (and
   2^-16 of sum |a b| entrywise) and ones @ 2I exactly 2, P3
   gather within 1e-5 of the largest |sum|, at a 32 MB pool (warm L2) and
   a 256 MB pool (L2 flushed before each call), each with the bytes and
   bound of its own indices; the yardsticks ``x.clone()`` (P1),
   ``torch.matmul`` (P2) and ``embedding_bag`` in mode "sum" (P3, checked
   against the plain gather) timed at the same shapes; P1 and
   ``x.clone()`` in 12 interleaved pairs (P1, clone, clone, P1, ...);
   P3 and ``embedding_bag`` in 12 pairs at both pools, and P3's kernel
   time from torch.profiler; at the 256 MB pool P3 in single calls after
   a write flush and after a read flush of L2 (and after a write flush
   without the settling sleep), in turns; then P3 at the main path's
   ladder sums (``_ladder_sums``, phase 4's plan): at every (class,
   ladder m) the step with the largest R, the kernel and
   ``embedding_bag`` within 1e-5 of the largest |sum| of the executor's
   ``call[gi[t]].sum(dim=1)``, the three timed with the call buffer
   written before each call, and one pass over every ladder sum of a
   factorize with each, against the pass's byte bound.  P2 at 128^3
   against a float64 product (the probe's bar 1e-5*K*max|a|*max|b| and
   2^-16 of sum |a b| entrywise) and against ``torch.matmul`` in 12
   interleaved pairs, with its kernel time from torch.profiler; then P2
   at the main path's update products (``_update_products``, on phase
   4's factor): for each of the 30 (c, Mc, K, Q) classes and both
   products of ``update_block`` (A B_raw^T, Chat S^T) the step with the
   most lanes, P2 and ``torch.bmm`` within the bar of a float64 product,
   each timed with its operands written before each call (events and
   torch.profiler) beside its bound and its 3xTF32 ceiling, and one pass
   over the 2,276 products of a factorize with each, P2's launches in it
   equal to the products.  The executor is not touched: phase 4 checked
   that its run launched P3 and P2 no time;
11. the scatter update mode at n = 110,592: a second ``CholeskySolver``
   with ``update_delta="scatter"`` (its own analyze); K1 counted as in
   phase 4; the captured ``factorize`` within 1e-6 of the pool scale of
   ``_factorize_eager`` (atomics: not bit-equal); phase 4's gates; the
   capture seconds, the replay median and the device busy ms; then the
   scaling driver's G = 1 row on this solver (``scripts/scaling.py``
   ``single_row``: ``factorize_segmented(group=8)`` first call, median of
   3, ``solve_lower`` median of 3, busy ms), kept for phase 16;
12. ``TriangularSolver`` at n = 110,592 on phase 4's factor (f32):
   supernodal, wavefront and coarsened, each with its analyze seconds,
   levels or steps, table MB (and ``prepare_solve_pools``' seconds),
   capture seconds and nodes, the ``solve`` and ``solve_transposed``
   medians of 5 after the first call, nnz/s, device operations, busy ms
   and the heaviest operations by name (torch.profiler), and the gates
   |1 - x_i| < 1e-3 with b = L*1 and b = L^T*1; "auto"'s pick; both
   pruned solvers on three RHS rows (reach, times, agreement with the
   full solve within 1e-5 of its scale).  No hand-written kernel lies on
   this path: every launch count stays 0;
13. the same, wavefront and coarsened, on a non-chordal L: the lower half
   of A;
14. ``CholeskySolver(tier="simplicial")`` at laplace_3d(SIMPLICIAL_GRID)
   (n = 8,000, 97.0M update triples), ND, f32: the factorize median of
   5, two factorizations within 1e-6 of their scale, the factor residual
   < 1e-3 and the solve residual < 1e-3;
15. the CLI (``CLI_RUNS``) as subprocesses on the card: each must exit 0
   and verify (the ``cholesky`` run with ``--profile``, whose line must
   carry the model's summary);
16. the multi-device tier (``parallel/``) in G rank processes
   (``parallel/comm.launch``), all on the first card with the gloo
   backend (NCCL with one card per rank only where the machine has G
   cards; ``parallel/comm.rank_layout``), on phase 4's matrix and
   ordering: ``DistExecutor`` at G = 8, 4 and 2 (``DIST_GROUPS``) with
   its own ``build_dist_plan``, and
   ``ShardedSupernodalExecutor`` at G = 4 on a plan built with
   ``num_partitions=4``, each held against phase 4's single-device factor
   (values within 1e-4; ``solve_lower`` with b = L*1 and ``solve_spd``
   with b = A*1 within 1e-3 of x = 1, the sharded ``solve_lower`` within
   1e-4 of phase 4's; ``factorize_segmented(group=8)`` within 1e-6 of the
   pool scale of ``factorize`` at G = 4 and 2 (``SEGMENTED_GROUPS``);
   pool bytes per rank below the
   single-device pools'), ``ShardedSimplicialExecutor`` at G = 4 on phase
   14's plan against its factor (within 1e-4 of the scale); every rank's
   factorize launched K1 once per chol call its plan implies (printed per
   rank), and each rank then held K1 against its plain version at every
   (P, c) its factorize gave K1, at phase 3's bars
   (``parallel/runs._check_k1``); the all_reduce payload of one
   ``DistExecutor`` factorize equal to ``DistPlan.psum_bytes_per_step()``'s
   model; the factorize median of ``DIST_REPS`` (3; 1 at G = 8, and 1
   for the simplicial job, ``SIMPLICIAL_REPS``; ``DistExecutor``:
   ``factorize_segmented(8)``, the scaling driver's) after one first call
   and the solve medians (host clock, synchronized), each rank's device
   busy ms of its first factorize (``scripts/attribution.profile`` in the
   rank: primed, retried by all ranks together).  Then the ``scaling``
   line: the scaling driver's rows at G = 1 (phase 11), 2, 4 and 8 built
   by its own functions from the ranks' records (``_scaling_rows``),
   gated on their keys (the JAX row's, then the port's), the ring bytes
   at every G and the pool bytes per device falling strictly with G.  A
   rank that raises or hangs fails the phase.  These walls come from
   host-staged collectives among ranks that share one card: no multi-GPU
   figure.  Phase 21's ``eval`` runs beside this phase;
17. the last single-device slice on phase 4's matrix: a second analyze
   with ``dense_top_cols=DENSE_TOP_COLS`` and ``verify=True`` (its
   ``verify_s``; ``verify_plan``'s stats on it and on phase 4's plan; the
   top's t, first level and ``solve_nseg``, Tinv MB, the aligned-operand
   pool's MB per executor); four forward-solve variants: phase 4's
   executor (no top, no pool), one on phase 4's plan with the pool
   (``gpool_mb=GPOOL_MB``), the top plan's, and the top plan with the
   pool, each pool on; the top plan's factorize with the counts at 0
   before (K1 twice the plan's calls, once per replay; pools within 1e-6
   of phase 4's scale); ``top_inverse`` alone with max|T Tinv - I| beside
   ``torch.linalg.solve_triangular(T, I)``; per variant ``solve_prep``
   (capture, nodes, replay) and ``solve_lower`` with b = L*1 (median of 5,
   ``solve_loop`` per iteration, device operations and busy ms with the
   heaviest by name; gates max|1 - x| < 1e-3 and within 1e-4 of phase 4's
   fast solve), with the slab pool's byte floor; ``save_analysis`` and
   ``from_artifact`` of phase 4's solver (times beside phase 4's analyze,
   K1 counted in the restored factorize, pools within 1e-6); the
   performance model fitted on ``profile_segments`` (``utils/calibrate``:
   constants, R^2, each segment's relative error, ``factorize_cost``
   under the committed ``ChipModel`` and under the fit against phase 4's
   median, and the fit over the committed constants); then the
   calibrate driver (``scripts/calibrate.py``) in this process: its
   seven ceilings, each beside ``ChipModel``'s field as measured /
   fitted, committed and this run's fit (``_calibrate_line``; reported,
   gated only on every value finite and > 0); peak memory.
18. the bench (``python -m parsy_bench_tpu_torch.bench``, the port's
   ``bench.py``) as a subprocess on the card (``BENCH_CMD``, at most
   900 s: its factor-residual gate is a host-side scipy L L^T at
   nnz(L) = 29.3M): exit 0, a last line that parses, exactly the bench's
   keys, phase 4's n, group 16, the factor residual and max|1 - x| <
   1e-3 and this card's name and power limit; its line, the process's
   seconds and phase 4's factorize median beside it.  Gated on
   correctness only, never on time;
19. the per-layer attribution scripts (``parsy_bench_tpu_torch/scripts/``)
   on phase 4's solver, each on an executor of its own: ``floor_r5`` over
   all segments in its five modes (``ATTR_REPS`` runs per sample), its
   ``layers_ms`` (device ms per scope of one profiled
   ``_factorize_eager``, whose step runs its pieces in the executor's
   scopes) beside phase 4's replayed busy ms; ``fin_ablate`` at segment 0;
   ``solve_floor`` at the prefixes ``SOLVE_KS``; whether the pools stay
   finite under ``profile_segments``' reps on their own output.  Gated on
   the ``full`` pools against ``_factorize_eager``'s (bit for bit, else
   within 1e-6 of the pool scale, flagged), the device time no scope
   covers (|other| at most 2 % of the pass's busy, and no scope opened
   inside another, which would count a kernel twice), K1's launches per
   mode (the captures and the profiler against the plan), the full
   solve's max|1 - x| < 1e-3, and every timed segment's ``full`` and
   restore above 0;
20. the reference-scale run (``python -m
   parsy_bench_tpu_torch.scripts.large_run``, the port's
   ``scripts/large_run.py``) as a subprocess on the card at
   ``laplace_3d(LARGE_GRID)``, n = 1,000,000 (``LARGE_TIMEOUT``): exit 0,
   its JSON file with exactly its keys in order, n, the scatter update
   mode, group 8, the SPD-solve gate and max|1 - x| < 1e-3, this card, K1
   launched once per plan call in each factorize (the programs' captures)
   and twice that over the run (warm-up and capture); then K1 against its
   plain version at every (P, c) of that run's batches that phase 3 did
   not check; then ``scale_test`` at ``SCALE_ARGS`` (k = 32, ND, 5
   iterations) as a subprocess: its three lines with their keys, this card
   and a factor residual < 1e-3.  Gated on correctness only, never on
   time;
21. the sweep drivers (``parsy_bench_tpu_torch/scripts/``) as subprocesses
   on the card, each with its own time limit: ``eval`` at ``EVAL_ARGS``
   (``laplace_3d(16)``, n = 4,096, with its trisolve and baseline runs:
   ``EVAL_LINES`` lines, none an error line, each Cholesky line's factor
   and solve residuals < 1e-3, each trisolve line verified, the device
   ``cuda``); ``h1_vs_coarse`` at ``H1_ARGS`` (``laplace_3d(24)``,
   n = 13,824, ND): a row per ``segment_alpha`` with its keys, this card,
   a residual < 1e-3 and K1's launches per factorize equal to that plan's
   K1 calls; ``calibrate_model`` at ``CAL_GRID`` (the main path): its
   artifact's keys, phase 4's segments, every fitted constant >= 0 and not
   NaN and each variant's gates.  ``eval`` runs in a thread beside phase
   16, whose rank processes' walls are no figure, and is joined when
   phase 16 ends, so no later phase shares the card with it; its lines'
   times are taken while the ranks share the card and the host, and it
   is checked here.  Then phase 17's ``profile_segments``
   time of each segment beside phase 19's restored ``full`` time
   (``_segment_times``: the ratio of the sums, the largest and smallest
   ratio of a segment, whether both rank the segments alike, whether they
   agree within ``SEGMENT_TIME_TOL``).  Gated on correctness only, never
   on time or on the model's signs.

Output: JSON lines of each phase's numbers, the card line, one JSON line
``{"kernels": [...]}`` (K1, K2, P1, P2, P3, each with the launches of its
path's run, its times, bound and yardstick; P1 with its pairs against
``x.clone()``, P2 with its pairs against ``torch.matmul``, its launches
in the main path's run (0) and the update products, P3 with each run's
bound, the flush study and the ladder sums; K1 and K2 also with their
launches per replay from the capture and from the profiler; K1 also with
its launches in each rank's factorize of phase 16, its checks at the
ranks' batch shapes, its launches in phase 17's factorizes and, per
script and mode, in phase 19's programs, and in phase 20's reference-scale
run with its checks at that run's new batch shapes, and per
``segment_alpha`` in phase 21's ``h1_vs_coarse``) and, last,
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of the JAX
package.
"""
from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

#: main-path batch shapes (P, c) of the chol_inverse kernel at
#: laplace_3d(48), checked against the plan below: the largest per width
#: class first, then a middle and the smallest c = 128 batches and the
#: second c = 32 batch
K1_SHAPES = ((27520, 32), (87, 128), (2215, 32), (2, 128), (1, 128))
#: widths the kernel takes off the main path, checked at a small batch
K1_SMALL = ((6, 8), (6, 16), (6, 48), (6, 64), (6, 96), (6, 112))
#: the fused path's K2 bucket shapes (P, H, c) at laplace_3d(48): the
#: largest lane count, a middle bucket and the tallest bucket (checked
#: against the plan below), and one c = 128 shape, a class the executor
#: leaves to K1
K2_SHAPES = ((27456, 32, 32), (640, 128, 32), (1, 4096, 32), (64, 128, 128))
#: the simplicial factorization's grid, laplace_3d(SIMPLICIAL_GRID): its
#: update tables hold one index triple per update (97.0M at 20 under ND;
#: 20.1e9 at 48, which no host holds)
SIMPLICIAL_GRID = 20
#: the CLI runs as subprocesses (``python -m parsy_bench_tpu_torch.cli``);
#: each must exit 0 and verify.  ``--tier simplicial`` makes the last one
#: run the coarsened schedule (the supernodal tier has no schedule)
CLI_RUNS = (("cholesky", "gen:laplace3d:24", "--verify", "--profile"),
            ("trisolve", "gen:laplace3d:20"),
            ("trisolve", "gen:laplace3d:48", "--lower", "--tier",
             "simplicial", "--schedule", "coarsened"))
#: phase 16: the group sizes of ``DistExecutor`` and of the sharded
#: executors (ranks share the card unless it has one card per rank)
DIST_GROUPS = (8, 4, 2)
SHARDED_G = 4
#: the timed repeats of each ``DistExecutor`` job and of the sharded
#: simplicial one, and the group sizes whose job checks
#: ``factorize_segmented``: G = 8's repeats and check and the simplicial
#: job's repeats are cut to keep the script inside its time limit (the
#: scaling driver's own run keeps the full protocol at every G)
DIST_REPS = {8: 1, 4: 3, 2: 3}
SIMPLICIAL_REPS = 1
SEGMENTED_GROUPS = (4, 2)
#: phase 17: the dense top's column budget (the width at which the JAX
#: package measured its dense top) and the aligned-operand pool's budget
#: in MB (the plan's default ``gpool_mb``)
DENSE_TOP_COLS = 4096
GPOOL_MB = 2048
#: phase 18: the bench's module as a subprocess (``python BENCH_CMD``)
BENCH_CMD = ("-m", "parsy_bench_tpu_torch.bench")
#: phase 19: floor_r5's runs per timed sample (its default, and JAX's,
#: is 20; fin_ablate keeps its 10) and solve_floor's segment prefixes
ATTR_REPS = 20
SOLVE_KS = (8, 16, 24, 34)
#: phase 20: the reference-scale run (``python LARGE_CMD out grid``) at
#: laplace_3d(LARGE_GRID), n = 1,000,000, and ``scale_test`` at
#: ``SCALE_ARGS`` (k ordering iters), each with its own time limit
LARGE_CMD = ("-m", "parsy_bench_tpu_torch.scripts.large_run")
LARGE_GRID = 100
LARGE_TIMEOUT = 600
SCALE_CMD = ("-m", "parsy_bench_tpu_torch.scripts.scale_test")
SCALE_ARGS = ("32", "nd", "5")
SCALE_TIMEOUT = 300
#: phase 21: the sweep drivers as subprocesses, each with its own time
#: limit: ``eval`` at a matrix of the JAX package's recorded set
#: (n = 4,096; EVAL_r05.jsonl) with its trisolve and baseline runs
#: (``EVAL_LINES`` lines), ``h1_vs_coarse`` at the JAX script's default
#: grid and ordering, ``calibrate_model`` at the main path's grid
EVAL_CMD = ("-m", "parsy_bench_tpu_torch.scripts.eval")
EVAL_ARGS = ("gen:laplace3d:16", "--iters", "3", "--trisolve",
             "--baselines")
EVAL_LINES = 9
EVAL_TIMEOUT = 600
H1_CMD = ("-m", "parsy_bench_tpu_torch.scripts.h1_vs_coarse")
H1_ARGS = ("24", "nd")
H1_TIMEOUT = 600
CAL_CMD = ("-m", "parsy_bench_tpu_torch.scripts.calibrate_model")
CAL_GRID = 48
CAL_TIMEOUT = 600
#: the relative gap within which phase 17's ``profile_segments`` times and
#: phase 19's restored ``full`` times count as the same, in sum and in
#: every segment
SEGMENT_TIME_TOL = 0.05
#: the kernels' names as torch.profiler shows them (csrc/chol_inverse.cu,
#: csrc/finalize_fused.cu)
K1_NAMES = ("chol_inverse_warp_kernel", "chol_inverse_blocked_kernel")
K2_NAMES = ("finalize_warp_kernel", "finalize_blocked_kernel")
#: P2's and P3's kernel names as torch.profiler shows them
#: (csrc/probes.cu; P2 has a small-tile and a 64-row kernel)
P2_NAMES = ("matmul_kernel", "matmul_wg_kernel")
P3_NAMES = ("gather_sum_kernel",)
#: the name of the operation that writes the ladder's call buffers (an
#: elementwise ``torch.mul``); no measured call launches it
FILL_NAME = "MulFunctor"


#: the H100 SXM's published peaks (NVIDIA's data sheet): HBM bytes/s and
#: float32 FLOP/s on the CUDA cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
#: the ceiling of an f32-accurate product on the tensor cores in 3xTF32:
#: three TF32 products each, a third of the dense TF32 rate (495 TFLOP/s)
PEAK_3XTF32_FLOP_PER_S = 495e12 / 3


def _bound(nbytes, flops):
    """(least ms the card could take, "bytes" or "operations"): the
    larger of the bytes over the memory rate and the FLOPs over the f32
    peak."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


#: bytes of the smallest unit the card's memory moves (an L2 sector)
SECTOR = 32


def _k1_work(P, c, itemsize):
    """(bytes, FLOPs) of K1 on a contiguous (P, c, c) batch: the 32-byte
    sectors that hold D's lower triangle, read once (the kernel reads
    nothing above the diagonal), and L and Linv written whole once; c^3/3
    for the Cholesky and c^3/3 for the inverse."""
    import numpy as np
    r = np.arange(P * c, dtype=np.int64)     # row i = r % c of block r // c
    start = r * c * itemsize
    end = start + (r % c + 1) * itemsize
    sectors = int(((end - 1) // SECTOR - start // SECTOR + 1).sum())
    return (sectors * SECTOR + 2 * P * c * c * itemsize,
            P * 2 * c ** 3 / 3)


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _sync_s(torch, fn):
    """Host seconds of one call, synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _check_k1(torch, dense, kernels, P, c, gen, dtype=None):
    """Kernel vs plain version on random masked-SPD blocks (P, c, c), f32
    (bars 1e-5*c on L, 1e-5 on Linv) or f64 (1e-10*c, 1e-10); times the
    kernel, the plain version and the library pair (``cholesky_ex`` then
    ``solve_triangular``: no one PyTorch call returns L and Linv)."""
    dev = "cuda"
    dtype = dtype or torch.float32
    tol = 1e-5 if dtype == torch.float32 else 1e-10
    A = torch.randn((P, c, c), generator=gen, device=dev, dtype=dtype)
    eye = torch.eye(c, device=dev, dtype=dtype)
    D0 = torch.bmm(A, A.transpose(1, 2)) + c * eye
    w = torch.randint(0, c + 1, (P,), generator=gen, device=dev,
                      dtype=torch.int32)
    w[::7] = 0
    w[1::7] = c
    D = dense.masked_spd(D0, w, c, dtype)
    L, Linv = kernels.cholesky_inverse_cuda(D)
    Lp, Linvp = dense.cholesky_inverse(D)
    torch.cuda.synchronize()
    err_l = float((L - Lp).abs().max())
    err_i = float((Linv - Linvp).abs().max())
    if not (err_l <= tol * c and err_i <= tol):
        raise AssertionError(f"K1 disagrees with its plain version at "
                             f"({P}, {c}, {dtype}): |dL| {err_l:.3e} (bar "
                             f"{tol * c:.1e}), |dLinv| {err_i:.3e} "
                             f"(bar {tol:.0e})")
    pad = w == 0
    if not (torch.equal(L[pad], eye.expand(int(pad.sum()), c, c))
            and torch.equal(Linv[pad], eye.expand(int(pad.sum()), c, c))):
        raise AssertionError(f"K1 padded lanes are not identity at c={c}")
    if not (torch.equal(torch.triu(L, 1), torch.zeros_like(L))
            and torch.equal(torch.triu(Linv, 1), torch.zeros_like(L))):
        raise AssertionError("K1 output not zero above the diagonal")
    res = (torch.linalg.matrix_norm(torch.bmm(L, L.transpose(1, 2)) - D)
           / torch.linalg.matrix_norm(D)).max().item()
    inv = torch.linalg.matrix_norm(torch.bmm(Linv, L) - eye).max().item()
    if not (res < 1e-5 and inv < 1e-4):
        raise AssertionError(f"K1 at ({P}, {c}): ||LL^T-D||/||D|| {res:.3e}"
                             f", ||Linv L - I|| {inv:.3e}")
    from parsy_bench_tpu_torch.probes import cuda_ms

    def library():
        Ll = torch.linalg.cholesky_ex(D).L
        return Ll, torch.linalg.solve_triangular(Ll, eye.expand(P, c, c),
                                                  upper=False)

    ms = cuda_ms(lambda: kernels.cholesky_inverse_cuda(D), 20)
    plain_ms = cuda_ms(lambda: dense.cholesky_inverse(D), 5)
    library_ms = cuda_ms(library, 5)
    nbytes, flops = _k1_work(P, c, D.element_size())
    bound_ms, bound_by = _bound(nbytes, flops)
    return dict(shape=[P, c, c], dtype=str(dtype).split(".")[-1],
                max_abs_err_L=err_l, max_abs_err_Linv=err_i,
                rel_residual=res, inverse_err=inv, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms,
                library="cholesky_ex + solve_triangular (two calls)",
                bound_ms=bound_ms, bound_by=bound_by,
                bound_share=bound_ms / ms, bytes=nbytes, flops=flops)


def _check_k2(torch, dense, kernels, P, H, c, gen, w=None, cnt=None,
              dtype=None):
    """K2 vs its plain version on a random bucket (P, H, c) with SPD tops,
    f32 (bar 1e-5*c of the largest |entry|) or f64 (1e-10*c): by default
    random widths with w = 0 and full-width lanes, and lanes at or beyond
    cnt; or the widths ``w`` and ``cnt`` given."""
    from parsy_bench_tpu_torch.probes import cuda_ms
    dev = "cuda"
    dtype = dtype or torch.float32
    tol = 1e-5 if dtype == torch.float32 else 1e-10
    blk = torch.randn((P, H, c), generator=gen, device=dev, dtype=dtype)
    A = torch.randn((P, c, c), generator=gen, device=dev, dtype=dtype)
    blk[:, :c, :] = (torch.bmm(A, A.transpose(1, 2))
                     + c * torch.eye(c, device=dev, dtype=dtype))
    if w is None:
        w = torch.randint(1, c + 1, (P,), generator=gen, device=dev,
                          dtype=torch.int32)
        w[1::7] = 0
        w[::7] = c
        cnt = P - P // 8
    diff = kernels.finalize_fused_cuda(blk, w, cnt)
    ref = dense.finalize_fused(blk, w, cnt)
    torch.cuda.synchronize()
    scale = max(1.0, float(ref.abs().max()))
    err = float((diff - ref).abs().max())
    if not err <= tol * c * scale:
        raise AssertionError(f"K2 disagrees with its plain version at ({P}, "
                             f"{H}, {c}, {dtype}): |d| {err:.3e} > "
                             f"{tol * c:.1e} * {scale:.3e}")
    if not torch.equal(diff[cnt:], torch.zeros_like(diff[cnt:])):
        raise AssertionError(f"K2 lanes at or beyond cnt are not zero at "
                             f"({P}, {H}, {c})")
    zero = (w == 0) & (torch.arange(P, device=dev) < cnt)
    if not torch.equal(diff[zero], -blk[zero]):
        raise AssertionError(f"K2 w = 0 lanes do not clear their block at "
                             f"({P}, {H}, {c})")
    ms = cuda_ms(lambda: kernels.finalize_fused_cuda(blk, w, cnt), 20)
    plain_ms = cuda_ms(lambda: dense.finalize_fused(blk, w, cnt), 5)
    # tall buckets: the time at other row-chunk counts (each chunk factors
    # its lane's top again), for the wrapper's choice
    nchunk = kernels.finalize_chunks(P, H, c)
    by_nchunk = {}
    if H > c and nchunk > 1:
        for n in sorted({1, max(1, nchunk // 4), nchunk,
                         min(2 * nchunk, -(-H // 8))}):
            got = kernels.finalize_fused_cuda(blk, w, cnt, n)
            if not float((got - ref).abs().max()) <= tol * c * scale:
                raise AssertionError(f"K2 at ({P}, {H}, {c}) in {n} chunks "
                                     f"disagrees with its plain version")
            by_nchunk[n] = cuda_ms(
                lambda: kernels.finalize_fused_cuda(blk, w, cnt, n), 20)
    # diff written once, w read, and blk read once on the lanes below cnt
    # (diff = out - blk needs all of it there, the top's upper triangle
    # too; the lanes at or beyond cnt are zeros and read nothing).  On
    # those lanes, at width wl = w clamped to [0, c]: the Cholesky and
    # inverse of the wl x wl top, 2 wl^3 / 3, and the panel product
    # Y = blk Linv^T on the rows below it, wl^2 per row
    item = blk.element_size()
    nbytes = P * H * c * item + P * 4 + cnt * H * c * item
    wl = w[:cnt].clamp(0, c).double()
    flops = float((2 * wl ** 3 / 3 + (H - wl) * wl ** 2).sum())
    bound_ms, bound_by = _bound(nbytes, flops)
    return dict(shape=[P, H, c], dtype=str(dtype).split(".")[-1], cnt=cnt,
                max_abs_err=err, scale=scale,
                ms=ms, plain_ms=plain_ms, library_ms=None, nchunk=nchunk,
                ms_by_nchunk=by_nchunk,
                bound_ms=bound_ms, bound_by=bound_by,
                bound_share=bound_ms / ms, bytes=nbytes, flops=flops)


def _device_ops(torch, fn, kernel=(), top=0):
    """One call under torch.profiler, after one unprofiled call
    (``attribution.profile``: its primer operations open the window, and a
    profile that lost them is taken again): its device operations
    (``ops``), their summed device ms (``busy_ms``), the ms from the first
    one's start to the last one's end (``span_ms``), the host ms around
    the synchronized call (``wall_ms``, profiler overhead included) and
    the idle share of the span and of the wall; with ``kernel`` (names),
    also the launches (``k_n``) and device ms (``k_ms``) of the operations
    whose name holds one of those strings; with ``top``, the ``top``
    operation names of the most device time (``by_name``: name, launches,
    ms).  Raises where the profile holds no device time, or none for
    ``kernel``."""
    from parsy_bench_tpu_torch.scripts import attribution
    dev = torch.device("cuda")
    evs, wall_ms, _ = attribution.profile(fn, dev)
    work = attribution._work(evs, dev)
    busy = sum(ms for _, ms in work)
    if not busy > 0:
        raise AssertionError("torch.profiler recorded no device time")
    span = (max(e.time_range.end for e, _ in work)
            - min(e.time_range.start for e, _ in work)) / 1e3
    out = dict(ops=len(work), busy_ms=busy, span_ms=span, wall_ms=wall_ms,
               idle_share_of_span=1 - busy / span,
               idle_share_of_wall=1 - busy / wall_ms)
    if kernel:
        mine = [ms for e, ms in work if any(k in e.name for k in kernel)]
        if not sum(mine) > 0:
            raise AssertionError(f"torch.profiler recorded no device time "
                                 f"for kernels named {kernel}")
        out.update(k_n=len(mine), k_ms=sum(mine))
    if top:
        names = {}
        for e, ms in work:
            names.setdefault(e.name, []).append(ms)
        out["by_name"] = sorted(
            ([k[:90], len(v), sum(v)] for k, v in names.items()),
            key=lambda r: -r[2])[:top]
    return out


def _l_ones(np, ex, solver, pools):
    """b = L*1 (float32) for the factor held in ``pools``."""
    import scipy.sparse as sp
    lpat, n = solver.lpat, solver.a.n
    lmat = sp.csc_matrix((ex.factor_values(pools).cpu().numpy().astype(
        np.float64), lpat.indices, lpat.indptr), shape=(n, n))
    return np.asarray(lmat @ np.ones(n), dtype=np.float32)


def _abba(torch, a, b, turns):
    """Host seconds of ``a`` and ``b``, synchronized, in turns a b b a a b
    b a ...; ``turns`` calls in all."""
    ta, tb = [], []
    for r in range(turns):
        if r % 4 in (0, 3):
            ta.append(_sync_s(torch, a)[0])
        else:
            tb.append(_sync_s(torch, b)[0])
    return sorted(ta), sorted(tb)


def _captured_programs(torch, np, ex, solver, expected, med, prof4,
                       card):
    """Phase 5 (the module docstring): the executor's captured programs
    against ``_factorize_eager`` at the main path's size."""
    from parsy_bench_tpu_torch.probes import cuda_ms
    data = solver.ap.data
    nseg = len(ex.plan.segments)
    eager = ex._factorize_eager(data)
    pscale = max(float(p.abs().max()) for p in eager)

    def agree(name, pools, ref=eager):
        """Bit for bit, else within 1e-6 of the pool scale (flagged)."""
        bit = all(torch.equal(p, q) for p, q in zip(pools, ref))
        diff = max(float((p - q).abs().max()) for p, q in zip(pools, ref))
        if not diff <= 1e-6 * pscale:
            raise AssertionError(f"{name}: pools differ from "
                                 f"_factorize_eager's by {diff:.3e} > "
                                 f"1e-6 * {pscale:.3e}")
        return dict(bit_equal=bit, max_abs_diff=diff)

    checks, groups = {}, {}
    for g in (8, 16):
        bounds = ex.group_bounds(g)
        if len(bounds) != -(-nseg // g):
            raise AssertionError(f"group {g}: {len(bounds)} programs for "
                                 f"{nseg} segments")
        checks[f"group {g}, first call"] = agree(
            f"factorize_segmented({g}), first call",
            ex.factorize_segmented(data, g))
        checks[f"group {g}, replay"] = agree(
            f"factorize_segmented({g})", ex.factorize_segmented(data, g))
        progs = [ex.programs["init"]] + [ex.programs[f"segments[{lo}:{hi}]"]
                                         for lo, hi in bounds]
        k1 = sum(p.launches["cholesky_inverse_cuda"] for p in progs)
        if k1 != expected:
            raise AssertionError(f"group {g}: K1 launched {k1} times per "
                                 f"replay of the programs; the plan "
                                 f"implies {expected}")
        groups[g] = dict(programs=len(bounds), bounds=bounds,
                         capture_s=sum(p.capture_s for p in progs),
                         nodes=sum(p.nodes for p in progs),
                         init_nodes=progs[0].nodes,
                         k1_launches_per_replay=k1)
    a_dev = torch.as_tensor(data).to(device="cuda", dtype=ex.dtype)
    checks["factorize"] = agree("factorize", ex.factorize(data))
    checks["factorize, A on the card"] = agree("factorize from a_dev",
                                               ex.factorize(a_dev))

    # aliasing: results of one call survive the next
    lx1 = ex.factorize(data)
    keep = [p.clone() for p in lx1]
    lx2 = ex.factorize(2 * data)
    if not all(torch.equal(p, q) for p, q in zip(lx1, keep)):
        raise AssertionError("a second factorize changed the first pools")
    checks["factorize, A scaled by 2"] = agree(
        "factorize(2A)", lx2, ex._factorize_eager(2 * data))
    b1, b2 = _l_ones(np, ex, solver, lx1), _l_ones(np, ex, solver, lx2)
    alias_err = []
    for pools, bl in ((lx1, b1), (lx2, b2), (lx1, b1)):
        err = float((ex.solve_lower(pools, bl) - 1).abs().max())
        if not err < 1e-3:
            raise AssertionError(f"solve_lower with b = L*1 after the "
                                 f"aliasing turns: max|1 - x| {err:.3e}")
        alias_err.append(err)
    prep1 = ex.solve_prep(lx1)
    linv1 = prep1[1]
    keep_l = [x.clone() for x in linv1]
    linv2 = ex.solve_prep(lx2)[1]
    if not (all(torch.equal(x, y) for x, y in zip(linv1, keep_l))
            and not all(torch.equal(x, y) for x, y in zip(linv1, linv2))):
        raise AssertionError("solve_prep did not give each factor its own "
                             "Linv pools")

    # times: the captured factorize against the eager loop (ABBA)
    t_cap, t_eag = _abba(torch, lambda: ex.factorize(data),
                         lambda: ex._factorize_eager(data), 10)
    t_dev = sorted(_sync_s(torch, lambda: ex.factorize(a_dev))[0]
                   for _ in range(3))
    t_loop = sorted(_sync_s(torch, lambda: ex.factorize_loop(data, 5))[0] / 5
                    for _ in range(3))
    clone_ms = cuda_ms(lambda: [p.clone() for p in ex._pools], 10)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ex._factorize_eager(data)
    eager_extra_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    torch.cuda.reset_peak_memory_stats()
    ex.factorize(data)
    replay_extra_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    prof_e = _device_ops(torch, lambda: ex._factorize_eager(data), K1_NAMES)

    # the fast forward solve: its program against its eager loop, and
    # solve_loop per iteration
    blv = ex._vec(b1)
    t_sc, t_se = _abba(torch, lambda: ex.solve_lower(lx1, b1),
                       lambda: ex._solve_lower_fast_impl(lx1, blv, *prep1),
                       8)
    xl = ex.solve_loop(lx1, b1, 5)
    loop_err = float((xl - 1).abs().max())
    if not loop_err < 1e-3:
        raise AssertionError(f"solve_loop with b = L*1: max|1 - x| "
                             f"{loop_err:.3e}")
    t_sloop = sorted(_sync_s(torch, lambda: ex.solve_loop(lx1, b1, 5))[0]
                     / 5 for _ in range(3))
    solve_progs = {k: dict(capture_s=ex.programs[k].capture_s,
                           nodes=ex.programs[k].nodes)
                   for k in ("solve_prep", "solve_lower_fast", "solve_spd")}

    # per-segment device times (group=1 programs)
    t0 = time.perf_counter()
    segs = ex.profile_segments(data)
    prof_s = time.perf_counter() - t0
    seg_sum = sum(r["median_s"] for r in segs)
    if not all(r["median_s"] > 0 for r in segs) or len(segs) != nseg:
        raise AssertionError("profile_segments gave a segment no time")
    top = sorted(segs, key=lambda r: -r["median_s"])[:5]
    fprog = ex.programs["factorize"]
    return dict(
        factorize_program=dict(capture_s=fprog.capture_s, nodes=fprog.nodes,
                               k1_launches_per_replay=fprog.launches[
                                   "cholesky_inverse_cuda"]),
        groups=groups, pool_checks=checks, pool_scale=pscale,
        aliasing_solve_lower_max_err=alias_err,
        captured_factorize_s=t_cap, eager_factorize_s=t_eag,
        captured_median_s=t_cap[2], eager_median_s=t_eag[2],
        captured_a_on_card_s=t_dev, factorize_loop_s_per_iter=t_loop,
        pools_clone_ms=clone_ms,
        eager_peak_extra_gb=eager_extra_gb,
        replay_peak_extra_gb=replay_extra_gb,
        eager_device_ops=prof_e["ops"],
        eager_device_busy_ms=prof_e["busy_ms"],
        eager_idle_share_of_median_wall=1 - prof_e["busy_ms"] / (
            t_eag[2] * 1e3),
        captured_idle_share_of_median_wall=1 - prof4["busy_ms"] / (
            t_cap[2] * 1e3),
        eager_k1_launches=prof_e["k_n"],
        solve_lower_captured_s=t_sc, solve_lower_eager_s=t_se,
        solve_loop_s_per_iter=t_sloop, solve_loop_max_err=loop_err,
        solve_programs=solve_progs,
        profile_segments_s=prof_s, segments_median_sum_s=seg_sum,
        segments_sum_over_busy=seg_sum * 1e3 / prof4["busy_ms"],
        segments_sum_over_wall_median=seg_sum / med,
        slowest_segments=top, card=card)


def _stats(t):
    s = sorted(t)
    return dict(median=statistics.median(s), min=s[0], max=s[-1], all=t)


def _interleaved(a, b, sample, pairs=12):
    """Medians and spread of two calls timed in turns (a, b, b, a, ...),
    ``pairs`` samples each, a sample ``sample(fn)`` ms; and in how many of
    the pairs a was the faster."""
    ta, tb = [], []
    for k in range(pairs):
        order = ((a, ta), (b, tb)) if k % 2 == 0 else ((b, tb), (a, ta))
        for fn, acc in order:
            acc.append(sample(fn))
    return dict(kernel=_stats(ta), other=_stats(tb),
                kernel_faster_in=sum(x < y for x, y in zip(ta, tb)),
                pairs=pairs)


def _profiled_ms(torch, fn, flush, names=(), reps=10, skip=(), expect=1):
    """(device ms per call, device operations per call, share seen) over
    ``reps`` calls of ``fn``, each after ``flush()``, from torch.profiler:
    the operations whose name holds one of ``names``, or with no
    ``names`` every operation but those whose name holds one of ``skip``
    (the flush's).  The calls launch ``expect`` operations each named by
    ``names`` (with ``skip``: each flush launches ``expect`` named by
    ``skip``).  The profile is ``attribution.profile``'s, taken again
    where it shows fewer than expected or none of the measured
    operations, and the last one's times are taken per call over the
    calls it shows (the share seen, the third value)."""
    from parsy_bench_tpu_torch.scripts import attribution
    dev = torch.device("cuda")

    def calls():
        for _ in range(reps):
            flush()
            fn()

    def split(evs):
        work = [e for e, _ in attribution._work(evs, dev)]
        if names:
            mine = [e for e in work if any(n in e.name for n in names)]
            return mine, len(mine)
        mine = [e for e in work if not any(n in e.name for n in skip)]
        return mine, len(work) - len(mine)
    evs, _, _ = attribution.profile(
        calls, dev, lambda evs: split(evs)[1] == expect * reps
        and bool(split(evs)[0]))
    mine, seen = split(evs)
    us = sum(e.device_time_total for e in mine)
    if not (seen > 0 and us > 0):
        raise AssertionError(f"torch.profiler recorded no device time for "
                             f"{names or 'the calls'}")
    calls_seen = seen / expect
    return us / 1e3 / calls_seen, len(mine) / calls_seen, seen / (
        expect * reps)


def _gather_probes(torch, np, kernels, probes, precs, gen):
    """Phase 10's probe shapes: P1 against ``x.clone()`` in 12 pairs; P2
    at 128^3 against a float64 product and against ``torch.matmul`` in 12
    pairs, and its kernel time from torch.profiler; P3
    and ``embedding_bag`` at both probe pools, timed as the probe timed
    them and in 12 pairs; at the 256 MB pool P3 after a write flush and
    after a read flush (with and without the settling sleep), single
    calls in turns, and P3's kernel time from torch.profiler after each
    flush."""
    import torch.nn.functional as F
    out = {}
    x = torch.arange(1024, dtype=torch.float32, device="cuda").reshape(8,
                                                                      128)
    out["p1_vs_clone"] = _interleaved(
        lambda: kernels.probe_copy_cuda(x), lambda: x.clone(),
        lambda fn: probes.cuda_ms(fn, 50))
    pa, pb = (torch.randn((128, 128), generator=gen, device="cuda")
              for _ in range(2))
    out["p_lib"] = [probes.cuda_ms(lambda: x.clone(), 50),
                    probes.cuda_ms(lambda: torch.matmul(pa, pb), 50)]

    def p2():
        return kernels.probe_matmul_cuda(pa, pb)
    err, bar, rel = probes.matmul_error(p2(), pa, pb)
    lib_err = probes.matmul_error(torch.matmul(pa, pb), pa, pb)[0]
    if not (err <= bar and rel <= probes.MATMUL_REL_BAR and lib_err <= bar):
        raise AssertionError(f"P2 at 128^3: |d| {err:.3e} (rel {rel:.3e}), "
                             f"torch.matmul {lib_err:.3e}; bar {bar:.3e}")
    out["p2"] = dict(
        max_abs_err_vs_f64=err, bar=bar, max_rel_err=rel,
        library_max_abs_err_vs_f64=lib_err,
        profiled_ms=_profiled_ms(torch, p2, lambda: None, P2_NAMES)[0],
        pairs_vs_library=_interleaved(
            p2, lambda: torch.matmul(pa, pb),
            lambda fn: probes.cuda_ms(fn, 50)))
    flush = probes.l2_flush("cuda")
    for r in [r for r in precs if r["variant"] == "gather"]:
        # the probe's pool and indices (the same seeds); embedding_bag
        # sums each group of PER packed rows into (G, 8c)
        rows = int(r["pool_mb"] * 2**20) // (probes.WIDTH * 4)
        pool8 = torch.randn((rows // 8, 8 * probes.WIDTH), device="cuda",
                            generator=torch.Generator(device="cuda")
                            .manual_seed(rows))
        idx32 = torch.as_tensor(probes.gather_indices(rows, probes.NIDX),
                                device="cuda")
        gidx = idx32.long().view(-1, probes.PER)

        def p3():
            return kernels.probe_gather_cuda(pool8, idx32, probes.PER)

        def bag():
            return F.embedding_bag(gidx, pool8, mode="sum")
        ref = probes.gather_plain(pool8, idx32, probes.PER)
        bag_err = float((bag().view(ref.shape) - ref).abs().max())
        if not bag_err <= 1e-5 * float(ref.abs().max()):
            raise AssertionError(f"embedding_bag differs from the plain "
                                 f"gather by {bag_err:.3e}")
        cold = r["l2"] == "cold"
        if cold:
            def sample(fn):
                return probes.cuda_ms_cold(fn, 5, flush)
        else:
            def sample(fn):
                return probes.cuda_ms(fn, 20)
        r["library_ms"] = (probes.cuda_ms_cold(bag, 20, flush) if cold
                           else probes.cuda_ms(bag, 20))
        r["library"] = "embedding_bag(mode='sum')"
        r["pairs_vs_library"] = _interleaved(p3, bag, sample)
        r["profiled_ms"], _, r["profiled_share_seen"] = _profiled_ms(
            torch, p3, flush if cold else (lambda: None), P3_NAMES)
        if not cold:
            continue
        # does the write flush put write-backs of dirty L2 lines inside
        # the timed call, and does the host's enqueue time fall inside it
        # without the settling sleep?  Single calls, in turns
        fl = {how: probes.l2_flush("cuda", how) for how in ("write",
                                                           "read")}
        conds = {"write": (fl["write"], True), "read": (fl["read"], True),
                 "write, no settle": (fl["write"], False)}
        times = {k: [] for k in conds}
        for rnd in range(24):
            keys = list(conds) if rnd % 2 == 0 else list(conds)[::-1]
            for k in keys:
                f, settle = conds[k]
                times[k].append(probes.cuda_ms_cold(p3, 1, f, settle))
        out["flush_study"] = dict(
            calls={k: _stats(v) for k, v in times.items()},
            profiled_ms={how: _profiled_ms(torch, p3, fl[how], P3_NAMES)[0]
                         for how in fl},
            chosen=probes.COLD_FLUSH)
        del fl
    return out


def _ladder_tables(np, plan):
    """The ladder sums of one factorize of ``plan`` in the executor's
    order, (segment, step, class, ladder index) each; the contribution
    rows (``ntot``) of each (segment, class) call buffer, less its zero
    row; and for every (c, m) the sum at the step with the largest R,
    then the most real entries."""
    sums, ntot, pick = [], {}, {}
    for k, seg in enumerate(plan.segments):
        for t in range(seg.nsteps):
            for ci, ent in enumerate(seg.gsc or ()):
                if ent is None:
                    continue
                ntot[k, ci] = int(ent["ntot"])
                for li, (m, g) in enumerate(zip(ent["ladder"],
                                                ent["gidx"])):
                    sums.append((k, t, ci, li))
                    key = (g.shape[1], int(np.count_nonzero(g[t])))
                    cm = (plan.classes[ci], m)
                    if cm not in pick or key > pick[cm][0]:
                        pick[cm] = (key, (k, t, ci, li))
    return sums, ntot, {cm: s for cm, (_, s) in pick.items()}


def _ladder_sums(torch, np, kernels, probes, plan, ex, gen):
    """Phase 10: P3 at the main path's ladder sums, not wired into the
    executor.  For every (class, ladder m) the step with the largest R:
    a call buffer of that step's ntot + 1 rows x c (seeded random values,
    row 0 zero), written right before each timed call as the executor's
    ``torch.cat`` writes it; ``gather_sum_cuda``, the executor's
    ``call[gi[t]].sum(dim=1)`` and ``embedding_bag`` on it, the kernel
    and the library within 1e-5 of the largest |sum| of the plain one;
    each timed by CUDA events (median of 10 calls) and by its device time
    in torch.profiler.  Then every ladder sum of one factorize in the
    executor's order, each after its call buffer's write: the device time
    of each method's pass from torch.profiler, the writes left out."""
    import torch.nn.functional as F
    sums, ntot, pick = _ladder_tables(np, plan)
    classes = plan.classes
    calls, srcs = {}, {}
    for ci in {ci for _, ci in ntot}:
        n = max(v for (_, cj), v in ntot.items() if cj == ci) + 1
        calls[ci] = torch.empty((n, classes[ci]), device="cuda")
        srcs[ci] = torch.randn((n, classes[ci]), generator=gen,
                               device="cuda")
        srcs[ci][0].zero_()

    def buf(k, ci):
        return calls[ci][:ntot[k, ci] + 1]

    def fill(k, ci):
        n = ntot[k, ci] + 1
        return lambda: torch.mul(srcs[ci][:n], 1.0, out=calls[ci][:n])

    def gi(k, t, ci, li):
        return ex._segs[k].gsc[ci]["gidx"][li][t]

    def m_of(k, ci, li):
        return plan.segments[k].gsc[ci]["ladder"][li]

    methods = {
        "kernel": lambda b, g, m: kernels.gather_sum_cuda(b, g.view(-1), m),
        "plain": lambda b, g, m: b[g].sum(dim=1),
        "library": lambda b, g, m: F.embedding_bag(g, b, mode="sum")}
    nbytes = {}
    for s in sums:
        k, t, ci, li = s
        nbytes[s] = probes.gather_bytes(
            plan.segments[k].gsc[ci]["gidx"][li][t], m_of(k, ci, li),
            classes[ci])
    shapes = []
    for (c, m), s in sorted(pick.items()):
        k, t, ci, li = s
        b, g = buf(k, ci), gi(*s)
        fill(k, ci)()
        ref = methods["plain"](b, g, m)
        bar = 1e-5 * float(ref.abs().max())
        rec = dict(c=c, m=m, R=int(g.shape[0]), segment=k, step=t,
                   call_rows=int(b.shape[0]), bytes=nbytes[s], bar=bar)
        for name in ("kernel", "library"):
            err = float((methods[name](b, g, m) - ref).abs().max())
            if not err <= bar:
                raise AssertionError(f"ladder sum (c, m) = ({c}, {m}): "
                                     f"{name} |d| {err:.3e} > {bar:.3e}")
            rec[f"{name}_max_abs_err"] = err
        for name, fn in methods.items():
            call = functools.partial(fn, b, g, m)
            rec[f"{name}_event_ms"] = probes.cuda_ms_cold(call, 10,
                                                          fill(k, ci))
            (rec[f"{name}_ms"], rec[f"{name}_ops"],
             rec[f"{name}_share_seen"]) = _profiled_ms(
                torch, call, fill(k, ci), skip=(FILL_NAME,))
        rec["bound_ms"] = _bound(nbytes[s], 0)[0]
        shapes.append(rec)

    def one_pass(fn):
        last = None
        for k, t, ci, li in sums:
            if (k, t, ci) != last:
                fill(k, ci)()
                last = (k, t, ci)
            fn(buf(k, ci), gi(k, t, ci, li), m_of(k, ci, li))
        torch.cuda.synchronize()

    # device time of one pass per method, the buffer writes left out
    fills = len({s[:3] for s in sums})
    prof = {name: _profiled_ms(
        torch, functools.partial(one_pass, fn), lambda: None, reps=1,
        skip=(FILL_NAME,), expect=fills)
        for name, fn in methods.items()}
    # the writes are told apart by name: P3's pass shows one operation
    # per sum besides them, within what a lossy profile allows (a write
    # counted as a sum would add one operation per call buffer)
    if abs(prof["kernel"][1] - len(sums)) > 0.1 * len(sums):
        raise AssertionError(f"the kernel's pass ran {prof['kernel'][1]} "
                             f"device operations besides the buffer writes "
                             f"for {len(sums)} sums")
    total = sum(nbytes.values())
    return dict(
        sums=len(sums), call_buffers=fills, bytes=total,
        bound_ms=_bound(total, 0)[0],
        **{f"{name}_ms": prof[name][0] for name in methods},
        **{f"{name}_ops": prof[name][1] for name in methods},
        **{f"{name}_share_seen": prof[name][2] for name in methods},
        shapes=shapes)


def _update_steps(plan, ex):
    """The update bucket-steps of one factorize in the executor's order,
    (segment, step, bucket) each, and for each (c, Mc, K, Q) class the
    step with the most lanes (the first of them)."""
    steps, pick = [], {}
    for k, seg in enumerate(plan.segments):
        for t in range(seg.nsteps):
            for bi, (b, ut) in enumerate(zip(seg.upd, ex._segs[k].upd)):
                steps.append((k, t, bi))
                key = (b.c, b.Mc, b.K, b.Q)
                lanes = int(ut.a8.shape[1])
                if key not in pick or lanes > pick[key][0]:
                    pick[key] = (lanes, (k, t, bi))
    return steps, {key: s for key, (_, s) in pick.items()}


def _update_operands(plan, ex, pools, s):
    """The operands of bucket-step s = (segment, step, bucket), built as
    ``ops/supernodal.update_block`` builds them from the packed pools: A
    (lanes, Mc, K), B_raw (lanes, Q, K) and the one-hot column selector S
    (lanes, c, Q).  The executor's products are A B_raw^T (Chat) and
    Chat S^T."""
    k, t, bi = s
    b, ut = plan.segments[k].upd[bi], ex._segs[k].upd[bi]
    pool8, ar = pools[b.kcls], ex._ar
    A = pool8[ut.a8[t][:, None] + ar(b.Mc // 8)].reshape(-1, b.Mc, b.K)
    Braw = pool8[ut.b8[t][:, None] + ar(b.Q // 8)].reshape(-1, b.Q, b.K)
    S = (ar(b.c)[None, :, None] == ut.colq[t][:, None, :]).to(ex.dtype)
    return A, Braw, S


def _product_work(L, M, N, K):
    """(bytes, FLOPs) of L f32 products (M, K) @ (N, K)^T: each operand
    read once, the (L, M, N) result written once; 2 L M N K."""
    return 4 * (L * M * K + L * N * K + L * M * N), 2 * L * M * N * K


def _tc_bound_ms(nbytes, flops):
    """The least ms at the 3xTF32 ceiling: the larger of the bytes over
    the memory rate and the FLOPs over ``PEAK_3XTF32_FLOP_PER_S``."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_3XTF32_FLOP_PER_S) \
        * 1e3


def _update_products(torch, np, kernels, probes, plan, ex, pools):
    """Phase 10: P2 at the main path's update products, not wired into the
    executor.  The products of ``ops/supernodal.update_block``, A B_raw^T
    and Chat S^T, on operands built from the factor's pools as the
    executor builds them (``_update_operands``; the step's
    ``update_block`` must equal ``bmm(bmm(A, B_raw^T), S^T)`` bit for
    bit).  For every (c, Mc, K, Q) class and each of its two products the
    step with the most lanes: P2 and ``torch.bmm`` within the bar of a
    float64 product on the card (P2 also within ``MATMUL_REL_BAR``
    entrywise), each timed with its operands written right before each
    call, by CUDA events (median of 10) and by its device time in
    torch.profiler, beside its bound.  Then every product of one
    factorize in the executor's order, each step's A, B_raw and S written
    before its two products (the second takes the first's result): the
    device time of each method's pass from torch.profiler, the writes
    left out, and P2's launches in one pass, which must equal the
    products."""
    from parsy_bench_tpu_torch.ops import supernodal
    steps, pick = _update_steps(plan, ex)
    shapes = []
    for key, s in sorted(pick.items()):
        k, t, bi = s
        b, ut = plan.segments[k].upd[bi], ex._segs[k].upd[bi]
        A, Braw, S = _update_operands(plan, ex, pools, s)
        Chat = torch.bmm(A, Braw.transpose(1, 2))
        C = supernodal.update_block(pools[b.kcls], ut.a8[t], ut.b8[t],
                                    ut.colq[t], b, ex._ar, ex.dtype)
        if not torch.equal(C, torch.bmm(Chat, S.transpose(1, 2))):
            raise AssertionError(f"update class {key}: the operands are not "
                                 f"update_block's")
        for which, (x, y) in (("A B_raw^T", (A, Braw)),
                              ("Chat S^T", (Chat, S))):
            x, y = x.contiguous(), y.contiguous()
            sx, sy = x.clone(), y.clone()

            def fill(x=x, y=y, sx=sx, sy=sy):
                torch.mul(sx, 1.0, out=x)
                torch.mul(sy, 1.0, out=y)
            methods = {
                "kernel": functools.partial(kernels.probe_matmul_cuda, x, y,
                                            True),
                "library": functools.partial(
                    lambda x, y: torch.bmm(x, y.transpose(1, 2)), x, y)}
            nbytes, flops = _product_work(*x.shape[:2], y.shape[1],
                                          x.shape[2])
            rec = dict(c=key[0], Mc=key[1], K=key[2], Q=key[3],
                       product=which, segment=k, step=t, bucket=bi,
                       L=int(x.shape[0]), M=int(x.shape[1]),
                       N=int(y.shape[1]), depth=int(x.shape[2]),
                       bytes=nbytes, flops=flops)
            err, bar, rel = probes.matmul_error(methods["kernel"](), x, y,
                                                True)
            lib_err, _, lib_rel = probes.matmul_error(methods["library"](),
                                                      x, y, True)
            if not (err <= bar and rel <= probes.MATMUL_REL_BAR
                    and lib_err <= bar):
                raise AssertionError(
                    f"update product {which} at {key}: P2 |d| {err:.3e} "
                    f"(rel {rel:.3e}), bmm {lib_err:.3e}; bar {bar:.3e}")
            rec.update(bar=bar, kernel_max_abs_err=err, kernel_max_rel_err=rel,
                       library_max_abs_err=lib_err,
                       library_max_rel_err=lib_rel)
            for name, call in methods.items():
                rec[f"{name}_event_ms"] = probes.cuda_ms_cold(call, 10, fill)
                (rec[f"{name}_ms"], rec[f"{name}_ops"],
                 rec[f"{name}_share_seen"]) = _profiled_ms(
                    torch, call, fill, skip=(FILL_NAME,), expect=2)
            rec["bound_ms"], rec["bound_by"] = _bound(nbytes, flops)
            rec["bound_3xtf32_ms"] = _tc_bound_ms(nbytes, flops)
            shapes.append(rec)
        del A, Braw, S, Chat, C, x, y, sx, sy

    # the pass: every step's operands kept (untimed), written into the
    # step's buffers before its products as the executor's gathers write
    # them
    srcs = [_update_operands(plan, ex, pools, s) for s in steps]
    size = [max(src[i].numel() for src in srcs) for i in range(3)]
    bufs = [torch.empty(n, device="cuda") for n in size]
    views = [tuple(buf[:src.numel()].view(src.shape)
                   for buf, src in zip(bufs, srcs_s)) for srcs_s in srcs]
    work = [w for A, Braw, S in srcs for w in (
        _product_work(*A.shape[:2], Braw.shape[1], A.shape[2]),
        _product_work(*A.shape[:2], S.shape[1], S.shape[2]))]

    def one_pass(fn):
        for src, (A, Braw, S) in zip(srcs, views):
            for buf, x in zip((A, Braw, S), src):
                torch.mul(x, 1.0, out=buf)
            fn(fn(A, Braw), S)
        torch.cuda.synchronize()

    methods = {
        "kernel": lambda x, y: kernels.probe_matmul_cuda(x, y, True),
        "library": lambda x, y: torch.bmm(x, y.transpose(1, 2))}
    kernels.probe_matmul_cuda.launches = 0
    one_pass(methods["kernel"])
    launches = kernels.probe_matmul_cuda.launches
    if launches != 2 * len(steps):
        raise AssertionError(f"P2 launched {launches} times in a pass of "
                             f"{2 * len(steps)} products")
    prof = {name: _profiled_ms(
        torch, functools.partial(one_pass, fn), lambda: None, reps=1,
        skip=(FILL_NAME,), expect=3 * len(steps))
        for name, fn in methods.items()}
    if abs(prof["kernel"][1] - 2 * len(steps)) > 0.1 * len(steps):
        raise AssertionError(f"P2's pass ran {prof['kernel'][1]} device "
                             f"operations besides the operand writes for "
                             f"{2 * len(steps)} products")
    nbytes = sum(w[0] for w in work)
    flops = sum(w[1] for w in work)
    out = dict(
        bucket_steps=len(steps), products=2 * len(steps),
        classes=len(pick), kernel_launches=launches,
        operand_mb=sum(x.numel() for src in srcs for x in src) * 4 / 1e6,
        bytes=nbytes, flops=flops,
        bound_ms=sum(_bound(*w)[0] for w in work),
        bound_3xtf32_ms=sum(_tc_bound_ms(*w) for w in work),
        **{f"{name}_ms": prof[name][0] for name in methods},
        **{f"{name}_ops": prof[name][1] for name in methods},
        **{f"{name}_share_seen": prof[name][2] for name in methods},
        shapes=shapes)
    del srcs, bufs, views
    return out


def _probe_phase(torch, np, kernels, plan, ex, pools, gen, card):
    """Phase 10 (the module docstring): the probes, then P3 at the main
    path's ladder sums and P2 at its update products (on the factor's
    ``pools``)."""
    from parsy_bench_tpu_torch import probes
    pk = (kernels.probe_copy_cuda, kernels.probe_matmul_cuda,
          kernels.gather_sum_cuda)
    for f in pk:
        f.launches = 0
    precs = probes.run()
    plaunch = [f.launches for f in pk]
    extra = _gather_probes(torch, np, kernels, probes, precs, gen)
    for r in precs:
        if r["variant"] == "gather":
            r["bound_ms"], r["bound_by"] = _bound(r["bytes"], 0)
        print("probe", json.dumps(r))
    print("P1 vs x.clone()", json.dumps(extra["p1_vs_clone"]))
    print("P2 at 128^3", json.dumps(extra["p2"]))
    print("P3 flush study, 256 MB pool", json.dumps(extra["flush_study"]))
    ladder = _ladder_sums(torch, np, kernels, probes, plan, ex, gen)
    for r in ladder["shapes"]:
        print("ladder shape", json.dumps(r))
    print("ladder pass", json.dumps(
        {k: v for k, v in ladder.items() if k != "shapes"}))
    products = _update_products(torch, np, kernels, probes, plan, ex, pools)
    for r in products["shapes"]:
        print("update product", json.dumps(r))
    print("update products pass", json.dumps(
        {k: v for k, v in products.items() if k != "shapes"}))
    gathers = [r for r in precs if r["variant"] == "gather"]
    x = 8 * 128 * 4
    return dict(
        precs=precs, plaunch=plaunch, gathers=gathers, ladder=ladder,
        products=products, p2=extra["p2"],
        p1_pairs=extra["p1_vs_clone"], flush_study=extra["flush_study"],
        p_lib=extra["p_lib"] + [gathers[0]["library_ms"]],
        # the copy's bytes; the product's bytes and FLOPs; the warm
        # gather's bytes from its own indices
        p_work=[(2 * x, 0), (3 * 128 * 128 * 4, 2 * 128 ** 3),
                (gathers[0]["bytes"], probes.NIDX * 8 * probes.WIDTH)],
        card=card)


def _scatter_phase(torch, np, kernels, a, cfg, card):
    """Phase 11 (the module docstring): the scatter update mode at the
    main path's size, its own analyze and captured ``factorize``."""
    from parsy_bench_tpu_torch import CholeskySolver
    from parsy_bench_tpu_torch.scripts import scaling
    scfg = cfg.replace(update_delta="scatter")
    t0 = time.perf_counter()
    solver = CholeskySolver(a, scfg)
    analyze_s = time.perf_counter() - t0
    ex = solver.executor
    if any(seg.gsc is not None for seg in solver.plan.segments):
        raise AssertionError("the scatter plan carries gather tables")
    expected = ex.chol_calls_per_factorize
    kernels.reset_launch_counts()
    warm_s, _ = _sync_s(torch, solver.factorize)
    prog = ex.programs["factorize"]
    times = sorted(_sync_s(torch, solver.factorize)[0] for _ in range(5))
    launches = kernels.cholesky_inverse_cuda.launches
    k1_per_replay = prog.launches["cholesky_inverse_cuda"]
    # P3 and P2 are measured in phase 10, not wired in
    p3_main = kernels.gather_sum_cuda.launches
    p2_main = kernels.probe_matmul_cuda.launches
    if p3_main != 0 or p2_main != 0:
        raise AssertionError(f"the scatter mode's run launched P3 {p3_main} "
                             f"and P2 {p2_main} times; the executor runs "
                             f"torch.bmm and index_add_")
    if (launches, k1_per_replay) != (2 * expected, expected):
        raise AssertionError(f"scatter mode: K1 counted {launches} launches "
                             f"and {k1_per_replay} in the capture; the plan "
                             f"implies {2 * expected} and {expected}")
    if not solver.factor_ok():
        raise AssertionError("scatter mode: factor has non-finite entries")
    data = solver.ap.data
    eager = ex._factorize_eager(data)
    pscale = max(float(p.abs().max()) for p in eager)
    diff = max(float((p - q).abs().max()) for p, q in zip(solver.lx, eager))
    if not diff <= 1e-6 * pscale:
        raise AssertionError(f"scatter mode: the captured factorize differs "
                             f"from _factorize_eager by {diff:.3e} > 1e-6 * "
                             f"{pscale:.3e}")
    bit = all(torch.equal(p, q) for p, q in zip(solver.lx, eager))
    b_l = _l_ones(np, ex, solver, solver.lx)
    err = float((ex.solve_lower(solver.lx, b_l) - 1).abs().max())
    if not err < 1e-3:
        raise AssertionError(f"scatter mode: solve_lower with b = L*1: "
                             f"max|1 - x| {err:.3e}")
    b = a.spd_rhs_for_ones()
    res = solver.solve_residual(b, solver.solve(b))
    if not res < 1e-3:
        raise AssertionError(f"scatter mode: solve(A*1) residual {res:.3e}")
    prof = _device_ops(torch, lambda: ex.factorize(data), K1_NAMES)
    med = times[2]
    # the scaling driver's G = 1 row (its configuration), for phase 16
    t0 = time.perf_counter()
    g1 = scaling.single_row(solver, torch.device("cuda"))
    g1_s = time.perf_counter() - t0
    return dict(
        update_delta=scfg.update_delta, n=int(a.n), analyze_s=analyze_s,
        chol_calls_per_factorize=expected, table_mb=ex.table_bytes / 1e6,
        warm_factorize_s=warm_s, capture_s=prog.capture_s,
        graph_nodes=prog.nodes, factorize_s_min_med_max=[times[0], med,
                                                         times[-1]],
        gflops=solver.plan.flops / med / 1e9,
        k1_launches_run=launches, k1_launches_per_replay=k1_per_replay,
        k1_profiled_launches_per_replay=prof["k_n"],
        device_ops=prof["ops"], device_busy_ms=prof["busy_ms"],
        idle_share_of_median_wall=1 - prof["busy_ms"] / (med * 1e3),
        captured_vs_eager_max_abs_diff=diff, captured_vs_eager_bit_equal=bit,
        pool_scale=pscale, solve_lower_max_err=err, solve_rel_residual=res,
        scaling_g1_row=g1, scaling_g1_s=g1_s, card=card)


def _trisolve(torch, np, name, l, cfg, card):
    """One ``TriangularSolver`` on the card (phases 12 and 13): analyze,
    the first ``solve`` and ``solve_transposed`` (their captures), five of
    each timed, the gates with b = L*1 and b = L^T*1, and one forward and
    one backward solve under torch.profiler.  Returns (record, solver)."""
    from parsy_bench_tpu_torch import TriangularSolver
    t0 = time.perf_counter()
    ts = TriangularSolver(l, cfg)
    torch.cuda.synchronize()
    analyze_s = time.perf_counter() - t0
    ex = ts.executor
    m = l.to_scipy()
    b = np.asarray(m @ np.ones(l.n))
    bt = np.asarray(m.T @ np.ones(l.n))
    rec = dict(variant=name, tier=cfg.tier,
               schedule=getattr(ts, "schedule", cfg.tier), dtype=cfg.dtype,
               n=int(l.n), nnz_l=int(l.nnz), nlev=int(ts.nlev),
               steps=int(getattr(ts.plan, "nsteps", ts.nlev)),
               analyze_s=analyze_s, table_mb=ex.table_bytes / 1e6)
    if cfg.tier == "supernodal":
        raw = ex.init_pools(l.data)
        rec["prepare_solve_capture_s"] = ex.programs["prepare_solve"].capture_s
        rec["prepare_solve_nodes"] = ex.programs["prepare_solve"].nodes
        rec["prepare_solve_s"] = min(
            _sync_s(torch, lambda: ex.prepare_solve_pools(raw))[0]
            for _ in range(3))
        rec["pool_mb"] = sum(p.numel() for p in raw) * raw[0].element_size() \
            / 1e6
    for fn, rhs in (("solve", b), ("solve_transposed", bt)):
        first_s, x = _sync_s(torch, lambda: getattr(ts, fn)(rhs))
        err = float(np.max(np.abs(x - 1.0)))
        if not err < 1e-3:
            raise AssertionError(f"{name}: {fn} with b = L*1 (L^T*1 for "
                                 f"the transposed): max|1 - x| {err:.3e}")
        times = sorted(_sync_s(torch, lambda: getattr(ts, fn)(rhs))[0]
                       for _ in range(5))
        rec[fn] = dict(first_s=first_s, s_min_med_max=[times[0], times[2],
                                                       times[-1]],
                       max_err=err, nnz_per_s=2 * l.nnz / times[2])
    for key, prog in ex.programs.items():
        rec.setdefault("programs", {})[key] = dict(
            capture_s=prog.capture_s, nodes=prog.nodes)
    bd = torch.as_tensor(b, device="cuda", dtype=ex.dtype)
    btd = torch.as_tensor(bt, device="cuda", dtype=ex.dtype)
    for fn, rhs in (("solve_lower", bd), ("solve_upper", btd)):
        prof = _device_ops(torch, lambda: getattr(ex, fn)(ts._lx, rhs),
                           top=6)
        rec[fn + "_device"] = dict(
            ops=prof["ops"], busy_ms=prof["busy_ms"],
            span_ms=prof["span_ms"], by_name=prof["by_name"])
    rec["card"] = card
    return rec, ts


def _pruned(torch, np, ts, rows, card):
    """The pruned solver of ``ts`` on one RHS pattern (``rows``): its
    build, reach and five timed solves after the first, against the full
    solve within 1e-5 of the full solution's scale."""
    t0 = time.perf_counter()
    ps = ts.pruned(rows)
    build_s = time.perf_counter() - t0
    b = np.zeros(ts.l.n)
    b[rows] = np.random.default_rng(0).standard_normal(len(rows))
    full = ts.solve(b)
    first_s, x = _sync_s(torch, lambda: ps.solve(b))
    scale = float(np.abs(full).max())
    err = float(np.abs(x - full).max())
    if not err <= 1e-5 * scale:
        raise AssertionError(f"pruned {ts.config.tier}: differs from the "
                             f"full solve by {err:.3e} > 1e-5 * {scale:.3e}")
    times = sorted(_sync_s(torch, lambda: ps.solve(b))[0] for _ in range(5))
    touched = ps.cols if ts.config.tier == "supernodal" else ps.reach
    out = dict(tier=ts.config.tier, rows=[int(r) for r in rows],
               reach=int(len(touched)), build_s=build_s, first_s=first_s,
               s_min_med_max=[times[0], times[2], times[-1]],
               max_abs_diff=err, scale=scale, card=card)
    if ts.config.tier == "supernodal":
        out["supernode_reach"] = int(len(ps.sn_reach))
    return out


def _simplicial_phase(torch, np, kernels, generate, card):
    """Phase 14: ``CholeskySolver(tier="simplicial")`` on
    laplace_3d(SIMPLICIAL_GRID), nested dissection, f32.  Returns (record,
    solver)."""
    from parsy_bench_tpu_torch import CholeskySolver, SolverConfig
    a = generate.laplace_3d(SIMPLICIAL_GRID)
    cfg = SolverConfig(ordering="nd", dtype="float32", tier="simplicial")
    t0 = time.perf_counter()
    solver = CholeskySolver(a, cfg)
    analyze_s = time.perf_counter() - t0
    ex = solver.executor
    data = solver.ap.data
    kernels.reset_launch_counts()
    warm_s, _ = _sync_s(torch, solver.factorize)
    times = sorted(_sync_s(torch, solver.factorize)[0] for _ in range(5))
    if any(kernels.launch_counts().values()):
        raise AssertionError(f"the simplicial tier launched a hand-written "
                             f"kernel: {kernels.launch_counts()}")
    if not solver.factor_ok():
        raise AssertionError("simplicial factor has non-finite entries")
    lx1 = solver.lx
    lx2 = ex.factorize(data)
    scale = float(lx1.abs().max())
    replay_diff = float((lx1 - lx2).abs().max())
    if not replay_diff <= 1e-6 * scale:
        raise AssertionError(f"two simplicial factorizations differ by "
                             f"{replay_diff:.3e} > 1e-6 * {scale:.3e}")
    t0 = time.perf_counter()
    resid = solver.factor_residual()
    resid_s = time.perf_counter() - t0
    if not resid < 1e-3:
        raise AssertionError(f"simplicial factor residual {resid:.3e}")
    b = a.spd_rhs_for_ones()
    sres = solver.solve_residual(b, solver.solve(b))
    if not sres < 1e-3:
        raise AssertionError(f"simplicial solve(A*1) residual {sres:.3e}")
    prog = ex.programs["factorize"]
    prof = _device_ops(torch, lambda: ex.factorize(data), top=6)
    med = times[2]
    return dict(
        tier="simplicial", update_delta=None, grid=SIMPLICIAL_GRID,
        n=int(a.n), nnz_l=int(solver.plan.nnz), nlev=int(solver.plan.nlev),
        update_triples=int(len(solver.plan.upd_a)),
        segments=ex.num_segments, analyze_s=analyze_s,
        timings=solver.timings, table_mb=ex.table_bytes / 1e6,
        warm_factorize_s=warm_s, capture_s=prog.capture_s,
        graph_nodes=prog.nodes,
        factorize_s_min_med_max=[times[0], med, times[-1]],
        gflops=solver.plan.flops_factor / med / 1e9,
        replay_max_abs_diff=replay_diff, factor_residual=resid,
        factor_residual_host_s=resid_s, solve_rel_residual=sres,
        device_ops=prof["ops"], device_busy_ms=prof["busy_ms"],
        idle_share_of_median_wall=1 - prof["busy_ms"] / (med * 1e3),
        by_name=prof["by_name"], card=card), solver


def _psum_model(plan, recs):
    """The measured all_reduce payload of one factorize against
    ``DistPlan.psum_bytes_per_step()`` (which models each rank's ring
    traffic, 2 (G-1)/G times the payload, at 4 bytes an entry)."""
    model = plan.psum_bytes_per_step()
    ring = 2.0 * (plan.G - 1) / plan.G
    got = [r["psum_bytes"] * ring for r in recs]
    if not all(g == model["factorize_bytes"] for g in got):
        raise AssertionError(f"all_reduce ring bytes {got} per factorize, "
                             f"the plan models {model['factorize_bytes']}")
    return dict(psum_calls=recs[0]["psum_calls"],
                psum_payload_bytes=recs[0]["psum_bytes"],
                psum_ring_bytes=got[0], model=model)


def _rank_summary(recs):
    """Per-rank numbers of one executor's run, and the medians of rank
    0's timed calls."""
    r0 = recs[0]
    if not all(r["digest"] == r0["digest"] and r["jax_free"] for r in recs):
        raise AssertionError("the ranks' arrays differ, or a rank loaded "
                             "jax or the JAX package")
    return dict(
        executor=r0["executor"], G=r0["size"], backend=r0["backend"],
        rank_devices=[r["device"] for r in recs],
        init_s=[r["init_s"] for r in recs],
        job_s=[r["job_s"] for r in recs],
        first_factorize_s=[r["first_factorize_s"] for r in recs],
        factorize_median_s=statistics.median(r0["factorize_s"]),
        factorize_s_rank0=r0["factorize_s"],
        factorize_median_s_by_rank=[statistics.median(r["factorize_s"])
                                    for r in recs],
        solve_median_s={k: statistics.median(v)
                        for k, v in r0["solve_s"].items()},
        k1_launches_per_factorize_by_rank=[r["k1_launches"] for r in recs],
        device_busy_ms_by_rank=[r.get("device_busy_ms") for r in recs])


def _check_rank_k1(recs):
    """K1 launched in every rank's factorize, once per chol call the plan
    implies (the card runs the rank's finalize through it), and held
    against its plain version at each of the rank's batch shapes (the
    rank raises if it disagrees).  Returns the checks: the distinct
    (P, c) over the ranks and the largest errors."""
    for r in recs:
        if not r["k1_launches"] == r["chol_calls_per_factorize"] > 0:
            raise AssertionError(
                f"{r['executor']} rank {r['rank']}: K1 launched "
                f"{r['k1_launches']} times in its factorize; the plan "
                f"implies {r['chol_calls_per_factorize']} (> 0)")
        if not r["k1_checks"]:
            raise AssertionError(f"{r['executor']} rank {r['rank']}: K1 "
                                 f"not checked at its batch shapes")
    checks = [ck for r in recs for ck in r["k1_checks"]]
    return dict(shapes=sorted({(P, c) for P, c, _, _ in checks}),
                max_abs_err_L=max(ck[2] for ck in checks),
                max_abs_err_Linv=max(ck[3] for ck in checks))


def _multi_device_phase(torch, np, solver, cfg, lref, b_l, bp, x_fast,
                        simp, g1_row, card):
    """Phase 16 (the module docstring): the multi-device tier in rank
    processes on the card, held against phase 4's single-device factor
    and phase 14's simplicial factor; then the scaling rows, G = 1 from
    phase 11 (``g1_row``)."""
    from parsy_bench_tpu_torch.parallel import comm, runs
    from parsy_bench_tpu_torch.scripts import scaling
    from parsy_bench_tpu_torch.symbolic.dplan import build_dist_plan
    from parsy_bench_tpu_torch.symbolic.splan import build_supernodal_plan
    t_phase = time.perf_counter()
    data = solver.ap.data
    solves = dict(solve_lower=b_l, solve_spd=bp)
    t0 = time.perf_counter()
    dplans = {G: build_dist_plan(solver.ap, solver.parent, solver.cc, G,
                                 cfg) for G in DIST_GROUPS}
    splan = build_supernodal_plan(
        solver.ap, solver.parent, solver.cc, None,
        cfg.replace(num_partitions=SHARDED_G))
    plans_s = time.perf_counter() - t0
    # the timed factorize is the scaling driver's, factorize_segmented(8)
    jobs = {G: [("dist", dict(plan=dplans[G], a_data=data, dtype="float32",
                              lpat=solver.lpat, solves=solves,
                              segmented=8 if G in SEGMENTED_GROUPS else None,
                              reps=DIST_REPS[G], profile=True,
                              time_group=scaling.GROUP))]
            for G in DIST_GROUPS}
    jobs[SHARDED_G] += [
        ("sharded_supernodal", dict(plan=splan, a_data=data, dtype="float32",
                                    solves=solves, reps=3, profile=True)),
        ("sharded_simplicial", dict(plan=simp.plan, a_data=simp.ap.data,
                                    dtype="float32", reps=SIMPLICIAL_REPS,
                                    profile=True))]
    single_pool_bytes = solver.plan.pool_elems() * 4
    lscale = float(np.abs(lref).max())
    simp_ref = simp.lx.cpu().numpy()
    out = dict(plans_s=plans_s, launches={}, card=card)
    dist_recs = {}
    for G in sorted(jobs, reverse=True):
        backend, devices = comm.rank_layout(G, "cuda")
        print(f"multi-device: G = {G}, backend {backend}, rank devices "
              f"{[str(d) for d in devices]}")
        t0 = time.perf_counter()
        res = comm.launch(runs.run_jobs, G, backend, devices, (jobs[G],),
                          timeout=900)
        out["launches"][G] = time.perf_counter() - t0
        for k, (name, _) in enumerate(jobs[G]):
            recs = [ranks[k] for ranks in res]
            rec = _rank_summary(recs)
            r0 = recs[0]
            if name == "dist":
                plan = dplans[G]
                dist_recs[G] = recs
                rec["k1_checks"] = _check_rank_k1(recs)
                err = float(np.abs(r0["values"] - lref).max())
                lower = float(np.abs(r0["solve_lower"] - 1).max())
                spd = float(np.abs(r0["solve_spd"] - 1).max())
                seg = (max(r["segmented_max_diff"] / r["pool_scale"]
                           for r in recs) if G in SEGMENTED_GROUPS
                       else None)
                if not (err < 1e-4 and lower < 1e-3 and spd < 1e-3
                        and (seg is None or seg <= 1e-6)):
                    raise AssertionError(
                        f"DistExecutor G = {G}: factor values off the "
                        f"single-device factor by {err:.3e} (bar 1e-4), "
                        f"max|1 - x| {lower:.3e} (solve_lower, b = L*1) "
                        f"and {spd:.3e} (solve_spd, b = A*1; bar 1e-3), "
                        f"factorize_segmented(8) off by {seg} of the "
                        f"pool scale (bar 1e-6)")
                if not r0["pool_bytes"] < single_pool_bytes:
                    raise AssertionError(
                        f"DistExecutor G = {G}: {r0['pool_bytes']} pool "
                        f"bytes per rank, not below the single-device "
                        f"{single_pool_bytes}")
                rec.update(_psum_model(plan, recs),
                           factor_max_abs_err=err, factor_scale=lscale,
                           solve_lower_max_err=lower,
                           solve_spd_max_err=spd,
                           segmented_rel_diff=seg,
                           pool_mb_per_rank=r0["pool_bytes"] / 1e6,
                           single_device_pool_mb=single_pool_bytes / 1e6,
                           chol_calls_per_factorize=r0[
                               "chol_calls_per_factorize"],
                           comm=plan.comm)
            elif name == "sharded_supernodal":
                rec["k1_checks"] = _check_rank_k1(recs)
                err = float(np.abs(r0["values"] - lref).max())
                lower = float(np.abs(r0["solve_lower"] - x_fast).max())
                spd = float(np.abs(r0["solve_spd"] - 1).max())
                if not (err < 1e-4 and lower < 1e-4 and spd < 1e-3):
                    raise AssertionError(
                        f"ShardedSupernodalExecutor G = {G}: factor values "
                        f"off the single-device factor by {err:.3e}, "
                        f"solve_lower off the single-device solve by "
                        f"{lower:.3e} (bars 1e-4), solve_spd max|1 - x| "
                        f"{spd:.3e} (bar 1e-3)")
                rec.update(psum_calls=r0["psum_calls"],
                           psum_payload_bytes=r0["psum_bytes"],
                           factor_max_abs_err=err,
                           solve_lower_max_diff=lower,
                           solve_spd_max_err=spd,
                           chol_calls_per_factorize=r0[
                               "chol_calls_per_factorize"])
            else:
                scale = float(np.abs(simp_ref).max())
                err = float(np.abs(r0["values"] - simp_ref).max())
                if not err < 1e-4 * scale:
                    raise AssertionError(
                        f"ShardedSimplicialExecutor G = {G}: L values off "
                        f"the SimplicialExecutor's by {err:.3e} > 1e-4 * "
                        f"{scale:.3e}")
                rec.update(grid=SIMPLICIAL_GRID, levels=r0["levels"],
                           psum_calls=r0["psum_calls"],
                           psum_payload_bytes=r0["psum_bytes"],
                           factor_max_abs_err=err, factor_scale=scale)
            print("multi-device", json.dumps(rec))
            out.setdefault("runs", []).append(rec)
    out["scaling"] = _scaling_rows(solver, dplans, dist_recs, g1_row, card)
    print("scaling", json.dumps(out["scaling"]))
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def _scaling_rows(solver, dplans, dist_recs, g1_row, card):
    """The scaling driver's rows (``scripts/scaling.py``) from phase 11's
    G = 1 row and the ``DistExecutor`` ranks' records, through the
    driver's own functions; gated on the rows' keys (the JAX row's, then
    the port's), the ring bytes at every G (``scaling.rank_row`` raises)
    and the pool bytes per device falling strictly with G."""
    from parsy_bench_tpu_torch.scripts import scaling
    rows = [g1_row] + [scaling.rank_row(dplans[G], solver, dist_recs[G])
                       for G in sorted(dist_recs)]
    t1 = g1_row["factorize_s"]
    rows = [scaling.with_efficiency(r, t1) for r in rows]
    keys = scaling.ROW_KEYS + scaling.EXTRA_KEYS
    pools = [r["pool_bytes_per_device"] for r in rows]
    if not (all(tuple(r) == keys for r in rows)
            and all(p > q for p, q in zip(pools, pools[1:]))):
        raise AssertionError(f"scaling rows: keys {[list(r) for r in rows]}"
                             f" (want {list(keys)}), pool bytes per device "
                             f"{pools} (want strictly falling with G)")
    return dict(rows=rows, card=card)


def _module_run(cmd, args, timeout):
    """(stdout, seconds) of ``python cmd args`` from the checkout's root;
    raises on a non-zero exit."""
    import os
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, *cmd, *args], cwd=root, env=env,
                         capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f"{' '.join(cmd)} {' '.join(args)} exited "
                             f"{run.returncode}: {run.stdout[-2000:]}\n"
                             f"{run.stderr[-2000:]}")
    return run.stdout, wall


def _cli_phase(np, card):
    """Phase 15: the CLI's subcommands as subprocesses on the card; each
    must exit 0 and verify."""
    out = []
    for args in CLI_RUNS:
        stdout, wall = _module_run(("-m", "parsy_bench_tpu_torch.cli"),
                                   [*args, "--device", "cuda"], 900)
        line = json.loads([ln for ln in stdout.splitlines()
                           if ln.startswith("{")][-1])
        ok = (line.get("verified") if args[0] == "trisolve"
              else line["factor_residual"] < 1e-3
              and line["solve_residual"] < 1e-3
              and ("--profile" not in args or line["model"]["model_s"] > 0))
        if not ok or line["device"].split(":")[0] != "cuda":
            raise AssertionError(f"{' '.join(args)} did not verify on the "
                                 f"card: {line}")
        out.append(dict(args=list(args), process_s=wall, line=line))
    return dict(runs=out, card=card)


def _bench_phase(n, med, card):
    """Phase 18: the bench's line from a subprocess on the card, held to
    its keys, phase 4's n, group 16, both gates and this card."""
    stdout, wall = _module_run(BENCH_CMD, [], 900)
    # imported after the run: the package's import builds the native
    # library, which a cold run (tools/bench_cold_warm.py) must build itself
    from parsy_bench_tpu_torch import bench
    line = json.loads(stdout.strip().splitlines()[-1])
    keys = bench.BENCH_KEYS + bench.EXTRA_KEYS
    if sorted(line) != sorted(keys):
        raise AssertionError(f"the bench's keys {sorted(line)} are not "
                             f"{sorted(keys)}")
    if not (line["n"] == n and line["group"] == 16
            and line["factor_residual"] < 1e-3
            and line["trisolve_residual"] < 1e-3
            and line["device"] == card):
        raise AssertionError(f"the bench's line does not hold n = {n}, "
                             f"group 16, both residuals < 1e-3 and the "
                             f"card {card!r}: {line}")
    return dict(line=line, process_s=wall, phase4_factorize_median_s=med,
                card=card)


def _attribution_phase(solver, expected, prof4, card):
    """Phase 19 (the module docstring): the three attribution scripts on
    phase 4's solver, which they leave as it was."""
    from parsy_bench_tpu_torch.scripts import (attribution, fin_ablate,
                                               floor_r5, solve_floor)
    secs = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        secs[name] = time.perf_counter() - t0
        return out
    fr = timed("floor_r5", lambda: floor_r5.run(
        solver, "cuda", reps=ATTR_REPS, all_modes=True))
    fa = timed("fin_ablate", lambda: fin_ablate.run(solver, "cuda",
                                                    segment=0))
    sf = timed("solve_floor", lambda: solve_floor.run(solver, "cuda",
                                                      ks=SOLVE_KS))
    own = timed("reps_on_own_output",
                lambda: attribution.reps_on_own_output(solver, "cuda"))
    lay = fr["layers_ms"]
    if not (abs(lay["other"]) <= 0.02 * lay["busy"]
            and fr["layers"]["nested"] == 0):
        raise AssertionError(f"floor_r5's scopes leave {lay['other']:.3f} "
                             f"of {lay['busy']:.3f} busy ms uncovered or "
                             f"count it twice (|other| > 2 %, or "
                             f"{fr['layers']['nested']} nested scopes): "
                             f"{fr['layers']['other_top']}")
    seg0 = attribution.k1_calls(solver.executor, 0)
    for name, rec, want in (
            ("floor_r5", fr, {m: expected if m in floor_r5.K1_MODES else 0
                              for m in floor_r5.ALL_MODES}),
            ("fin_ablate", fa, {m: seg0 if m in fin_ablate.K1_MODES else 0
                                for m in fin_ablate.VARIANTS})):
        got = {m: r["capture"] for m, r in rec["k1_launches"].items()}
        prof = {m: r["profiled"] for m, r in rec["k1_launches"].items()}
        if not got == prof == want:
            raise AssertionError(f"{name}: K1 launches per mode {got} "
                                 f"(captures), {prof} (profiler); the plan "
                                 f"implies {want}")
    if not sf["full_err"] < 1e-3:
        raise AssertionError(f"solve_floor's full solve: max|1 - x| "
                             f"{sf['full_err']:.3e} >= 1e-3")
    times = [r["full"] for r in fr["segments"]] + [
        r["restore_s"] for r in fr["segments"]] + [fa["full"]] + list(
        sf["prefix_s"].values())
    if not (len(fr["segments"]) == len(solver.plan.segments)
            and min(times) > 0 and fa["slices_ops"] == 0):
        raise AssertionError("phase 19: a timed segment reads 0, a segment "
                             "was not timed or the slices launched work")
    print("phase 19 floor_r5", json.dumps(fr))
    print("phase 19 fin_ablate", json.dumps(fa))
    print("phase 19 solve_floor", json.dumps(sf))
    print("phase 19 profile_segments reps", json.dumps(own))
    print("phase 19 layers", json.dumps(dict(
        layers_ms=lay, other_top=fr["layers"]["other_top"],
        eager_pass_ops=fr["layers"]["ops"],
        phase4_replayed_busy_ms=prof4["busy_ms"],
        phase4_replayed_ops=prof4["ops"], card=card)))
    return dict(phase_s=sum(secs.values()), script_s=secs, k1_launches=dict(
        floor_r5=fr["k1_launches"], fin_ablate=fa["k1_launches"]),
        full_s=[r["full"] for r in fr["segments"]])


def _reference_scale_phase(torch, dense, kernels, checked, card):
    """Phase 20 (the module docstring): the reference-scale run at
    ``laplace_3d(LARGE_GRID)`` and ``scale_test`` at ``SCALE_ARGS`` as
    subprocesses on the card, and K1 at the large run's batch shapes that
    phase 3 did not check."""
    import os
    import tempfile
    from parsy_bench_tpu_torch.scripts import large_run
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "large_run.json")
        stdout, large_s = _module_run(
            LARGE_CMD, [path, str(LARGE_GRID), "--device", "cuda"],
            LARGE_TIMEOUT)
        with open(path) as f:
            line = json.load(f)
    stages = [json.loads(ln) for ln in stdout.splitlines()
              if ln.startswith('{"stage"')]
    keys = list(large_run.ART_KEYS + large_run.EXTRA_KEYS)
    k1 = line.get("k1_launches_per_factorize")
    if not (list(line) == keys and line["n"] == LARGE_GRID ** 3
            and line["update_delta"] == "scatter"
            and line["group"] == 8
            and line["factor_residual"] < 1e-3
            and line["trisolve_residual"] < 1e-3
            and line["device"] == card
            and k1 == line["chol_calls_per_factorize"] > 0
            and line["k1_launches_run"] == 2 * k1):
        raise AssertionError(
            f"the large run's line does not hold its keys {keys}, "
            f"n = {LARGE_GRID ** 3}, the scatter mode, group 8, both gates "
            f"< 1e-3, the card {card!r}, and K1 once per plan call per "
            f"factorize and twice over the run (warm-up and capture): "
            f"{line}")
    gen = torch.Generator(device="cuda").manual_seed(20)
    new = sorted({tuple(s) for s in line["k1_shapes"]} - set(checked))
    k1_checks = [_check_k1(torch, dense, kernels, P, c, gen)
                 for P, c in new]
    for r in k1_checks:
        print("phase 20 K1", json.dumps(r))
    stdout, scale_s = _module_run(
        SCALE_CMD, [*SCALE_ARGS, "--device", "cuda"], SCALE_TIMEOUT)
    scale = [json.loads(ln) for ln in stdout.splitlines()
             if ln.startswith("{")]
    want = [("analyze_s", "table_MB", "pool_MB", "executor_table_MB"),
            ("factorize_s", "gflops", "residual"),
            ("trisolve_s", "trisolve_gnnz_per_s")]
    if not (len(scale) == 3
            and all(set(k) <= set(s) and s["device"] == card
                    for k, s in zip(want, scale))
            and scale[1]["residual"] < 1e-3
            and scale[1]["factorize_s"] > 0 and scale[2]["trisolve_s"] > 0):
        raise AssertionError(f"scale_test {' '.join(SCALE_ARGS)}: three "
                             f"lines with their keys, the card {card!r} and "
                             f"a factor residual < 1e-3 expected: {scale}")
    return dict(line=line, stages=stages, large_run_process_s=large_s,
                k1_checks=k1_checks, scale_test=scale,
                scale_test_args=list(SCALE_ARGS), scale_test_process_s=scale_s,
                phase_s=time.perf_counter() - t_phase, card=card)


def _segment_times(profiled, restored):
    """Phase 17's ``profile_segments`` time of each segment beside phase
    19's restored ``full`` time of it (restore subtracted): their ratios,
    the ratio of their sums, whether both rank the segments alike, and
    whether they agree within ``SEGMENT_TIME_TOL`` in sum and in every
    segment."""
    if len(profiled) != len(restored):
        raise AssertionError(f"{len(profiled)} profiled segments against "
                             f"{len(restored)} restored ones")
    ratios = [p / r for p, r in zip(profiled, restored)]
    sum_ratio = sum(profiled) / sum(restored)

    def order(t):
        return sorted(range(len(t)), key=t.__getitem__)
    return dict(
        profiled_s=list(profiled), restored_full_s=list(restored),
        ratios=ratios, sum_ratio=sum_ratio, max_ratio=max(ratios),
        min_ratio=min(ratios),
        worst_segment=max(range(len(ratios)),
                          key=lambda i: abs(ratios[i] - 1)),
        same_ranking=order(profiled) == order(restored),
        within_tol=abs(sum_ratio - 1) <= SEGMENT_TIME_TOL
        and all(abs(r - 1) <= SEGMENT_TIME_TOL for r in ratios),
        tol=SEGMENT_TIME_TOL)


def _sweep_phase(evaluation, nseg, profiled, restored, card):
    """Phase 21 (the module docstring): the sweep drivers as subprocesses
    on the card, gated on correctness only, then phase 17's and phase 19's
    per-segment times side by side (``_segment_times``).  ``evaluation``
    is the (stdout, seconds) of the ``eval`` run that went beside phase
    16."""
    import os
    import tempfile
    from parsy_bench_tpu_torch import CholeskySolver
    from parsy_bench_tpu_torch.core import generate
    from parsy_bench_tpu_torch.scripts import calibrate_model, h1_vs_coarse
    from parsy_bench_tpu_torch.utils import calibrate
    t_phase = time.perf_counter()
    out = dict(card=card)

    # h1_vs_coarse: four rows with their keys, the residual, the card and
    # K1 once per plan call in each factorize
    with tempfile.TemporaryDirectory() as tmp:
        stdout, out["h1_process_s"] = _module_run(
            H1_CMD, [*H1_ARGS, "--out", os.path.join(tmp, "h1.jsonl"),
                     "--device", "cuda"], H1_TIMEOUT)
    rows = [json.loads(ln) for ln in stdout.splitlines()
            if ln.startswith("{")]
    keys = list(h1_vs_coarse.ROW_KEYS + h1_vs_coarse.EXTRA_KEYS)
    a24 = generate.laplace_3d(int(H1_ARGS[0]))
    want = [CholeskySolver(a24, h1_vs_coarse.config(H1_ARGS[1], alpha),
                           device="cuda").executor.chol_calls_per_factorize
            for alpha in h1_vs_coarse.ALPHAS]
    got = [r.get("k1_launches_per_factorize") for r in rows]
    if not (len(rows) == len(h1_vs_coarse.ALPHAS)
            and all(list(r) == keys and r["residual"] < 1e-3
                    and r["device"] == card for r in rows)
            and got == want):
        raise AssertionError(f"h1_vs_coarse {' '.join(H1_ARGS)}: "
                             f"{len(h1_vs_coarse.ALPHAS)} rows with the keys "
                             f"{keys}, residual < 1e-3, the card {card!r} "
                             f"and K1 launches per factorize {want} "
                             f"expected: {rows}")
    out["h1_vs_coarse"] = rows
    out["k1_launches_per_alpha"] = {str(r["segment_alpha"]): n
                                    for r, n in zip(rows, got)}

    # calibrate_model at the main path's grid: its keys, every segment,
    # the fitted constants and each variant's gates
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "calibration.json")
        _, out["calibrate_process_s"] = _module_run(
            CAL_CMD, [str(CAL_GRID), path, "--device", "cuda"],
            CAL_TIMEOUT)
        with open(path) as f:
            art = json.load(f)
    consts = [art["fitted"][c] for c in calibrate.COLUMNS]
    signs = art["validation"]["signs"]
    if not (list(art) == list(calibrate_model.ART_KEYS
                              + calibrate_model.EXTRA_KEYS)
            and art["segments"] == nseg and art["device"] == card
            and all(v is None or v >= 0 for v in consts)
            and list(signs) == list(calibrate_model.VARIANTS)
            and all(s["gates"]["passed"] for s in signs.values())):
        raise AssertionError(f"calibrate_model {CAL_GRID}: its keys, {nseg} "
                             f"segments, the card {card!r}, fitted "
                             f"constants >= 0 and not NaN (null: a rate at "
                             f"no cost) and every variant's gates expected: "
                             f"{art}")
    out["calibrate_model"] = art

    # eval: every line verifies on the card
    stdout, out["eval_process_s"] = evaluation
    lines = [json.loads(ln) for ln in stdout.splitlines()
             if ln.startswith("{")]

    def verified(ln):
        if ln.get("driver") == "cholesky":
            return (ln["factor_residual"] < 1e-3
                    and ln["solve_residual"] < 1e-3
                    and ln["device"].split(":")[0] == "cuda")
        if ln.get("driver") == "trisolve":
            return ln["verified"] and ln["device"].split(":")[0] == "cuda"
        return ln.get("driver") == "baseline" and ln["trsv_verified"]
    if not (len(lines) == EVAL_LINES and all(map(verified, lines))):
        raise AssertionError(f"eval {' '.join(EVAL_ARGS)}: {EVAL_LINES} "
                             f"verified lines on the card expected, none an "
                             f"error line: {lines}")
    out["eval"] = lines

    out["segment_times"] = _segment_times(profiled, restored)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def _variant_solve(torch, np, name, ex, lx, b_l, x_ref, card):
    """Phase 17's record of one fast forward solve variant: ``solve_prep``
    (capture seconds and nodes, its program's replay time, one call on new
    pools), then ``solve_lower`` with b = L*1 (first call, median of 5),
    ``solve_loop(lx, b, 5)`` per iteration, one solve under
    torch.profiler, and the gates: max|1 - x| < 1e-3 and agreement with
    phase 4's fast solve within 1e-4 of its scale."""
    from parsy_bench_tpu_torch.probes import cuda_ms
    lxc = tuple(p.clone() for p in lx)
    first_prep_s, _ = _sync_s(torch, lambda: ex.solve_prep(lxc))
    prog = ex.programs["solve_prep"]
    prep_ms = cuda_ms(prog.run, 3)
    prep_call_s, _ = _sync_s(torch, lambda: ex.solve_prep(lx))
    first_s, x = _sync_s(torch, lambda: ex.solve_lower(lx, b_l))
    times = sorted(_sync_s(torch, lambda: ex.solve_lower(lx, b_l))[0]
                   for _ in range(5))
    x = x.cpu().numpy()
    err = float(np.abs(x - 1.0).max())
    scale = float(np.abs(x_ref).max())
    diff = float(np.abs(x - x_ref).max())
    if not (err < 1e-3 and diff <= 1e-4 * scale):
        raise AssertionError(f"{name}: solve_lower with b = L*1: max|1 - x| "
                             f"{err:.3e} (bar 1e-3), {diff:.3e} off phase "
                             f"4's fast solve (bar 1e-4 * {scale:.3e})")
    loop = sorted(_sync_s(torch, lambda: ex.solve_loop(lx, b_l, 5))[0] / 5
                  for _ in range(3))
    xl = ex.solve_loop(lx, b_l, 5).cpu().numpy()
    loop_err = float(np.abs(xl - 1.0).max())
    if not loop_err < 1e-3:
        raise AssertionError(f"{name}: solve_loop with b = L*1: max|1 - x| "
                             f"{loop_err:.3e}")
    bd = torch.as_tensor(b_l, device="cuda", dtype=ex.dtype)
    prof = _device_ops(torch, lambda: ex.solve_lower(lx, bd), top=6)
    fast = ex.programs["solve_lower_fast"]
    rec = dict(
        variant=name, top=ex._top is not None,
        gpool_enabled=ex._gpool_enabled,
        gpool_mb=getattr(ex, "_gpool_bytes", 0) / 1e6,
        solve_prep_capture_s=prog.capture_s, solve_prep_nodes=prog.nodes,
        solve_prep_first_call_s=first_prep_s, solve_prep_replay_ms=prep_ms,
        solve_prep_call_s=prep_call_s,
        solve_capture_s=fast.capture_s, solve_nodes=fast.nodes,
        solve_first_s=first_s,
        solve_s_min_med_max=[times[0], times[2], times[-1]],
        solve_loop_s_per_iter=loop, solve_max_err=err,
        solve_loop_max_err=loop_err, vs_phase4_max_abs_diff=diff,
        vs_phase4_scale=scale, device_ops=prof["ops"],
        device_busy_ms=prof["busy_ms"], device_span_ms=prof["span_ms"],
        idle_share_of_median_wall=1 - prof["busy_ms"] / (times[2] * 1e3),
        by_name=prof["by_name"], card=card)
    if ex._gpool_enabled:
        # a slab-fed solve reads every slab once: its byte floor
        rec["gpool_read_floor_ms"] = ex._gpool_bytes / PEAK_BYTES_PER_S * 1e3
    return rec


def _last_slice_phase(torch, np, kernels, a, cfg, solver, analyze_s, med,
                      b_l, x_fast, card):
    """Phase 17 (the module docstring): the dense top, the aligned-operand
    pool, ``verify_plan``, the analysis artifacts and the performance
    model's fit, on phase 4's matrix."""
    import dataclasses
    import os
    import tempfile

    from parsy_bench_tpu_torch import CholeskySolver
    from parsy_bench_tpu_torch.ops.supernodal import SupernodalExecutor
    from parsy_bench_tpu_torch.probes import cuda_ms
    from parsy_bench_tpu_torch.symbolic.verify import verify_plan
    from parsy_bench_tpu_torch.utils import calibrate, perfmodel
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    ex, plan = solver.executor, solver.plan
    expected = ex.chol_calls_per_factorize
    out = dict(card=card)

    # ---- analyze with a dense top, verify=True
    t0 = time.perf_counter()
    tsolver = CholeskySolver(a, cfg.replace(dense_top_cols=DENSE_TOP_COLS,
                                            verify=True))
    out["top_analyze_s"] = time.perf_counter() - t0
    out["top_timings"] = tsolver.timings
    tplan, tex = tsolver.plan, tsolver.executor
    top = tplan.top
    if top is None or not 0 < tplan.solve_nseg < len(tplan.segments):
        raise AssertionError(f"dense_top_cols={DENSE_TOP_COLS} gave no "
                             f"partial dense top (solve_nseg "
                             f"{tplan.solve_nseg} of {len(tplan.segments)})")
    t0 = time.perf_counter()
    out["verify_top_plan"] = verify_plan(tplan)
    out["verify_top_plan_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["verify_phase4_plan"] = verify_plan(plan)
    out["verify_phase4_plan_s"] = time.perf_counter() - t0
    out.update(dense_top_cols=DENSE_TOP_COLS, t=int(top.t),
               lev0=int(top.lev0), solve_nseg=int(tplan.solve_nseg),
               segments=len(tplan.segments), top_update_buckets=len(
                   top.supd), tinv_mb=top.t ** 2 * 4 / 1e6)
    variants = {
        "top off, pool off (phase 4)": (ex, solver),
        "top off, pool on": (SupernodalExecutor(dataclasses.replace(
            plan, gpool_mb=GPOOL_MB), "float32", "cuda"), solver),
        "top on, pool off": (tex, tsolver),
        "top on, pool on": (SupernodalExecutor(dataclasses.replace(
            tplan, gpool_mb=GPOOL_MB), "float32", "cuda"), tsolver)}
    for name, (vex, _) in variants.items():
        if "pool on" in name and not vex._gpool_enabled:
            raise AssertionError(f"{name}: the aligned-operand pool is off "
                                 f"at a {GPOOL_MB} MB budget "
                                 f"({vex._gpool_bytes / 2**20:.1f} MiB)")
    out["gpool_mb"] = {k: v[0]._gpool_bytes / 1e6
                       for k, v in variants.items()}
    print("phase 17 plan", json.dumps(out))

    # ---- the top plan's factorize: the path's run, counts at 0 before
    kernels.reset_launch_counts()
    warm_s, _ = _sync_s(torch, tsolver.factorize)
    times = sorted(_sync_s(torch, tsolver.factorize)[0] for _ in range(3))
    launches = kernels.cholesky_inverse_cuda.launches
    per_replay = tex.programs["factorize"].launches["cholesky_inverse_cuda"]
    if (launches, per_replay) != (2 * expected, expected):
        raise AssertionError(f"top plan: K1 counted {launches} launches and "
                             f"{per_replay} per replay; the plan implies "
                             f"{2 * expected} and {expected}")
    pscale = max(float(p.abs().max()) for p in solver.lx)
    pdiff = max(float((p - q).abs().max())
                for p, q in zip(tsolver.lx, solver.lx))
    if not pdiff <= 1e-6 * pscale:
        raise AssertionError(f"top plan's pools differ from phase 4's by "
                             f"{pdiff:.3e} > 1e-6 * {pscale:.3e}")
    out["top_factorize"] = dict(
        warm_s=warm_s, s_min_med_max=[times[0], times[1], times[-1]],
        k1_launches_run=launches, k1_launches_per_replay=per_replay,
        pools_vs_phase4_max_abs_diff=pdiff, pool_scale=pscale,
        pools_bit_equal=all(torch.equal(p, q)
                            for p, q in zip(tsolver.lx, solver.lx)))
    print("phase 17 top factorize", json.dumps(out["top_factorize"]))

    # ---- top_inverse alone, against the library's triangular solve
    first_s, tinv = _sync_s(torch, lambda: tex.top_inverse(tsolver.lx))
    T = tex._top_dense(tsolver.lx)
    eye = torch.eye(top.t, device="cuda", dtype=T.dtype)
    inv_err = float((T.double() @ tinv.double()
                     - eye.double()).abs().max())
    lib = torch.linalg.solve_triangular(T, eye, upper=False)
    lib_err = float((T.double() @ lib.double() - eye.double()).abs().max())
    out["top_inverse"] = dict(
        first_call_s=first_s, capture_s=tex.programs["top_inverse"].capture_s,
        nodes=tex.programs["top_inverse"].nodes,
        replay_ms=cuda_ms(tex.programs["top_inverse"].run, 3),
        max_T_Tinv_minus_I=inv_err, tinv_max_abs=float(tinv.abs().max()),
        library_ms=cuda_ms(lambda: torch.linalg.solve_triangular(
            T, eye, upper=False), 3),
        library="torch.linalg.solve_triangular(T, I)",
        library_max_T_X_minus_I=lib_err,
        tinv_vs_library_max_abs_diff=float((tinv - lib).abs().max()))
    print("phase 17 top_inverse", json.dumps(out["top_inverse"]))

    # ---- solve_prep and the fast solve of each variant
    out["solves"] = []
    for name, (vex, vs) in variants.items():
        rec = _variant_solve(torch, np, name, vex, vs.lx, b_l, x_fast, card)
        print("phase 17 solve", json.dumps(rec))
        out["solves"].append(rec)

    # ---- the analysis artifact of phase 4's solver
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "analysis.pbt")
        save_s, _ = _sync_s(torch, lambda: solver.save_analysis(path))
        art_mb = os.path.getsize(path) / 1e6
        t0 = time.perf_counter()
        restored = CholeskySolver.from_artifact(a, path, cfg)
        load_s = time.perf_counter() - t0
    if not np.array_equal(restored.perm, solver.perm):
        raise AssertionError("the restored solver's permutation differs")
    kernels.reset_launch_counts()
    rwarm_s, _ = _sync_s(torch, restored.factorize)
    rlaunches = kernels.cholesky_inverse_cuda.launches
    if rlaunches != 2 * expected:
        raise AssertionError(f"restored solver: K1 counted {rlaunches} "
                             f"launches; the plan implies {2 * expected}")
    rdiff = max(float((p - q).abs().max())
                for p, q in zip(restored.lx, solver.lx))
    if not rdiff <= 1e-6 * pscale:
        raise AssertionError(f"restored solver's pools differ from phase "
                             f"4's by {rdiff:.3e} > 1e-6 * {pscale:.3e}")
    out["artifact"] = dict(
        save_s=save_s, artifact_mb=art_mb, from_artifact_s=load_s,
        phase4_analyze_s=analyze_s, warm_factorize_s=rwarm_s,
        k1_launches_run=rlaunches, pools_vs_phase4_max_abs_diff=rdiff,
        pools_bit_equal=all(torch.equal(p, q)
                            for p, q in zip(restored.lx, solver.lx)))
    del restored
    print("phase 17 artifact", json.dumps(out["artifact"]))

    # ---- the performance model: fit on this run's segment times
    t0 = time.perf_counter()
    rows = calibrate.collect(solver)
    fitted = calibrate.fit(rows)
    fit_s = time.perf_counter() - t0
    consts = {c: fitted[c] for c in calibrate.COLUMNS}
    committed = perfmodel.ChipModel()
    chip_fit = dataclasses.replace(committed, name="this run's fit",
                                   **consts)
    pred = [perfmodel._segment_time(r, chip_fit) for r in rows]
    out["model"] = dict(
        fit_s=fit_s, fitted={k: (None if np.isinf(v) else float(v))
                             for k, v in fitted.items()},
        fitted_repr={c: repr(float(fitted[c])) for c in calibrate.COLUMNS},
        segment_rel_err=[(p - r["median_s"]) / r["median_s"]
                         for p, r in zip(pred, rows)],
        segments_measured_s=[r["median_s"] for r in rows],
        committed=dataclasses.asdict(committed),
        fit_over_committed={c: (float(consts[c] / getattr(committed, c))
                                if getattr(committed, c) not in (0, np.inf)
                                and np.isfinite(consts[c]) else None)
                            for c in calibrate.COLUMNS},
        model_s_committed=perfmodel.factorize_cost(plan).model_s,
        model_s_fit=perfmodel.factorize_cost(plan, chip_fit).model_s,
        measured_factorize_median_s=med,
        segments_measured_sum_s=sum(r["median_s"] for r in rows))
    print("phase 17 model", json.dumps(out["model"]))
    out["calibrate"] = _calibrate_line(committed, chip_fit, card)
    print("phase 17 calibrate", json.dumps(out["calibrate"]))
    out["peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["reserved_gb"] = torch.cuda.memory_reserved() / 1e9
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def _calibrate_line(committed, fit, card):
    """The calibrate driver's ceilings (``scripts/calibrate.py``, in this
    process) beside ``ChipModel``'s fields, committed and this run's fit,
    each as measured / fitted.  Reported, not gated, but for one gate:
    every measured value finite and above 0."""
    import math

    from parsy_bench_tpu_torch.scripts import calibrate
    t0 = time.perf_counter()
    got = calibrate.run("cuda")
    run_s = time.perf_counter() - t0
    vals = {k: got[k] for k in calibrate.FIELDS}
    if not all(math.isfinite(v) and v > 0 for v in vals.values()):
        raise AssertionError(f"calibrate: a ceiling not finite and > 0: "
                             f"{vals}")
    return dict(measured=vals, committed=calibrate.beside(vals, committed),
                this_run_fit=calibrate.beside(vals, fit),
                checksums=got["checksums"], device=got["device"],
                run_s=run_s, card=card)


def main() -> int:
    # the port must not reach jax; make any such import fail loudly
    sys.modules["jax"] = None
    import torch

    # ---- 1. device -----------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = _card()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("float32 matmul precision is not 'highest'")

    import numpy as np

    import parsy_bench_tpu_torch.native as native
    from parsy_bench_tpu_torch import CholeskySolver, SolverConfig
    from parsy_bench_tpu_torch.core import generate
    from parsy_bench_tpu_torch.ops import build, dense, kernels

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    so = build.build()
    kernels._load()
    build_s = time.perf_counter() - t0
    print(f"build: {so} in {build_s:.2f} s")
    print(build.build_log(so).strip())
    print("native inspector library: "
          + ("loaded" if native.lib is not None else
             "NOT loaded (numpy fallback: analyze is slow)"))

    # ---- 3. K1 against its plain version ------------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    k1 = [_check_k1(torch, dense, kernels, P, c, gen)
          for P, c in K1_SHAPES]
    k1_small = [_check_k1(torch, dense, kernels, P, c, gen)
                for P, c in K1_SMALL]
    k1_f64 = [_check_k1(torch, dense, kernels, P, c, gen, torch.float64)
              for P, c in ((64, 32), (8, 128))]
    for r in k1 + k1_small + k1_f64:
        print("K1", json.dumps(r))
    for c in (16, 32, 48, 128):
        D = torch.eye(c, device="cuda").repeat(2, 1, 1) * 4.0
        D[1, 3, 3] = -1.0
        L, Linv = kernels.cholesky_inverse_cuda(D)
        if not (torch.isfinite(L[0]).all() and torch.isfinite(Linv[0]).all()
                and torch.isnan(L[1]).any() and torch.isnan(Linv[1]).any()):
            raise AssertionError(f"K1 does not give NaN on a negative "
                                 f"pivot at c = {c}")
    if kernels.cholesky_inverse_cuda(D[:0])[0].shape != (0, c, c):
        raise AssertionError("K1 mishandles an empty batch")

    # ---- 4. main path at n = 110,592 ----------------------------------
    a = generate.laplace_3d(48)
    cfg = SolverConfig(ordering="nd", dtype="float32", tier="supernodal")
    t0 = time.perf_counter()
    solver = CholeskySolver(a, cfg)
    analyze_s = time.perf_counter() - t0
    ex = solver.executor
    plan = solver.plan
    expected = ex.chol_calls_per_factorize
    shapes = ex.chol_batch_shapes()
    largest = tuple(sorted((max(P for P, c in shapes if c == cls), cls)
                           for cls in {c for _, c in shapes}))
    smallest128 = min(P for P, c in shapes if c == 128)
    if (tuple(sorted(K1_SHAPES[:2])) != largest
            or not set(K1_SHAPES) <= shapes or smallest128 != 1):
        raise AssertionError(f"plan's chol batches {sorted(shapes)} do not "
                             f"hold the shapes phase 3 checked {K1_SHAPES} "
                             f"(the largest per class first)")
    stats = dict(
        segments=len(plan.segments),
        level_steps=sum(s.nsteps for s in plan.segments),
        update_bucket_steps=sum(s.nsteps * len(s.upd)
                                for s in plan.segments),
        finalize_bucket_steps=sum(s.nsteps * len(s.fin)
                                  for s in plan.segments),
        update_delta=cfg.update_delta,
        chol_calls_per_factorize=expected,
        table_mb=ex.table_bytes / 1e6,
        pool_mb=plan.pool_elems() * 4 / 1e6)
    print("plan", json.dumps(stats), "timings", json.dumps(solver.timings))

    # the main path's run: the first factorize warms the executor's
    # program up (K1 launched for real) and captures it (K1 launched into
    # the graph); the five timed calls replay it, which counts nothing
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    warm_s, _ = _sync_s(torch, solver.factorize)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    reserved_gb = torch.cuda.memory_reserved() / 1e9
    prog = ex.programs["factorize"]
    times = [_sync_s(torch, solver.factorize)[0] for _ in range(5)]
    launches = kernels.cholesky_inverse_cuda.launches
    k1_per_replay = prog.launches["cholesky_inverse_cuda"]
    # P3 is measured at the ladder sums and P2 at the update products
    # (phase 10), neither wired in
    p3_main = kernels.gather_sum_cuda.launches
    p2_main = kernels.probe_matmul_cuda.launches
    if p3_main != 0 or p2_main != 0:
        raise AssertionError(f"the main path's run launched P3 {p3_main} "
                             f"and P2 {p2_main} times; the executor runs "
                             f"the plain ladder sums and torch.bmm")
    if (launches, k1_per_replay) != (2 * expected, expected):
        raise AssertionError(
            f"K1 counted {launches} launches in the main path's run and "
            f"{k1_per_replay} in the capture; the plan implies "
            f"{2 * expected} (warm-up and capture) and {expected}")
    if not solver.factor_ok():
        raise AssertionError("factor has non-finite entries")
    times.sort()
    med = times[len(times) // 2]
    # K1's share of one replayed factorize's device time, by kernel name
    prof4 = _device_ops(torch, lambda: ex.factorize(solver.ap.data),
                        K1_NAMES)
    k1_prof_n, k1_dev_ms = prof4["k_n"], prof4["k_ms"]
    if k1_prof_n != expected:
        raise AssertionError(f"torch.profiler saw {k1_prof_n} K1 launches "
                             f"in one replayed factorize; the plan implies "
                             f"{expected}")

    lmat = solver.factor_csc().to_scipy()
    b_l = np.asarray(lmat @ np.ones(a.n), dtype=np.float32)
    x = ex.solve_lower(solver.lx, b_l)
    lower_s = min(_sync_s(torch, lambda: ex.solve_lower(solver.lx, b_l))[0]
                  for _ in range(3))
    solve_err = float(np.max(np.abs(x.cpu().numpy() - 1.0)))
    if not solve_err < 1e-3:
        raise AssertionError(f"solve_lower with b = L*1: max|1 - x| "
                             f"{solve_err:.3e} >= 1e-3")
    b = a.spd_rhs_for_ones()
    bp = b[solver.perm].astype(np.float32)
    spd_s = min(_sync_s(torch, lambda: ex.solve_spd(solver.lx, bp))[0]
                for _ in range(3))
    xs = solver.solve(b)
    solve_res = solver.solve_residual(b, xs)
    if not solve_res < 1e-3:
        raise AssertionError(f"solve(A*1): ||Ax - b||/||b|| "
                             f"{solve_res:.3e} >= 1e-3")
    main = dict(
        n=int(a.n), nnz_l=int(solver.cc.sum()), gflop=plan.flops / 1e9,
        analyze_s=analyze_s, build_s=build_s, warm_factorize_s=warm_s,
        factorize_s_min_med_max=[times[0], med, times[-1]],
        gflops=plan.flops / med / 1e9, solve_spd_s=spd_s,
        solve_lower_s=lower_s, solve_lower_max_err=solve_err,
        solve_rel_residual=solve_res, peak_device_gb=peak_gb,
        reserved_device_gb=reserved_gb,
        capture_s=prog.capture_s, graph_nodes=prog.nodes,
        k1_ms={f"{r['shape'][0]}x{r['shape'][1]}": r["ms"] for r in k1},
        k1_plain_ms={f"{r['shape'][0]}x{r['shape'][1]}": r["plain_ms"]
                     for r in k1},
        device_ops_per_factorize=prof4["ops"],
        device_busy_ms=prof4["busy_ms"], device_span_ms=prof4["span_ms"],
        profiled_wall_ms=prof4["wall_ms"],
        idle_share_of_span=prof4["idle_share_of_span"],
        idle_share_of_wall=prof4["idle_share_of_wall"],
        # against the unprofiled median: the profiler's tracing slows the
        # replay down
        idle_share_of_median_wall=1 - prof4["busy_ms"] / (med * 1e3),
        k1_device_ms=k1_dev_ms, k1_launches_main_path_run=launches,
        k1_launches_per_replay=k1_per_replay,
        k1_profiled_launches_per_replay=k1_prof_n,
        p3_launches_main_path_run=p3_main,
        update_delta=cfg.update_delta, card=card)
    print(json.dumps(main))

    # ---- 5. the captured programs at n = 110,592 -----------------------
    captured = _captured_programs(torch, np, ex, solver, expected, med,
                                  prof4, card)
    captured["update_delta"] = cfg.update_delta
    print("captured", json.dumps(captured))

    # ---- 6. factor residual at n = 13,824 ------------------------------
    small = CholeskySolver(generate.laplace_3d(24), cfg,
                           device="cuda").factorize()
    residual = small.factor_residual()
    print(f"factor residual at n=13824: {residual:.3e} (update_delta "
          f"{cfg.update_delta})")
    if not residual < 1e-3:
        raise AssertionError(f"factor residual {residual:.3e} >= 1e-3")

    # ---- 7. K2 against its plain version ------------------------------
    from parsy_bench_tpu_torch.ops.supernodal import SupernodalExecutor
    exf = SupernodalExecutor(plan, "float32", "cuda", fused_finalize=True)
    fshapes = {(seg.fin[k].P, seg.fin[k].H, seg.fin[k].c)
               for seg, tabs in zip(plan.segments, exf._segs)
               for ks in tabs.fin_fused for k in ks}
    want = (max(fshapes), max(fshapes, key=lambda x: (x[1], x[0])))
    if (want != (K2_SHAPES[0], K2_SHAPES[2])
            or K2_SHAPES[1] not in fshapes):
        raise AssertionError(f"plan's fused buckets (largest P, tallest) "
                             f"{want} are not the shapes phase 7 checks "
                             f"{K2_SHAPES[:3]}")
    k2 = [_check_k2(torch, dense, kernels, P, H, c, gen)
          for P, H, c in K2_SHAPES]
    # the leaf once more at its widths and cnt in the plan (most lanes
    # there are one column wide)
    leaf = next(seg.fin[k] for seg, tabs in zip(plan.segments, exf._segs)
                for ks in tabs.fin_fused for k in ks
                if (seg.fin[k].P, seg.fin[k].H, seg.fin[k].c) == K2_SHAPES[0])
    k2_leaf = _check_k2(torch, dense, kernels, *K2_SHAPES[0], gen,
                        torch.as_tensor(np.asarray(leaf.w)[0], device="cuda",
                                        dtype=torch.int32),
                        int(np.asarray(leaf.cnt).ravel()[0]))
    k2_leaf["widths"] = "the plan's"
    vals, counts = np.unique(np.asarray(leaf.w)[0], return_counts=True)
    k2_leaf["width_counts"] = dict(zip(map(str, vals.tolist()),
                                       counts.tolist()))
    k2_f64 = [_check_k2(torch, dense, kernels, P, H, c, gen,
                        dtype=torch.float64)
              for P, H, c in ((64, 70, 32), (8, 160, 64))]
    for r in k2 + [k2_leaf] + k2_f64:
        print("K2", json.dumps(r))
    blk = (torch.eye(32, device="cuda") * 4.0).repeat(2, 2, 1)
    blk[1, 3, 3] = -1.0
    diff = kernels.finalize_fused_cuda(
        blk, torch.full((2,), 32, dtype=torch.int32, device="cuda"), 2)
    if not (torch.isfinite(diff[0]).all() and torch.isnan(diff[1]).any()):
        raise AssertionError("K2 does not give NaN on a negative pivot")

    # ---- 8. the fused configuration at n = 110,592 ---------------------
    fexp = (exf.fused_calls_per_factorize, exf.chol_calls_per_factorize)
    print("fused plan", json.dumps(dict(
        k2_calls_per_factorize=fexp[0], k1_calls_per_factorize=fexp[1],
        k1_calls_per_factorize_default=expected,
        k2_shapes=sorted(fshapes))))
    data = solver.ap.data

    def counts():
        return (kernels.finalize_fused_cuda.launches,
                kernels.cholesky_inverse_cuda.launches)

    # the fused path's run: the first call warms up and captures the fused
    # executor's factorize program, the timed calls of both executors
    # replay theirs and count nothing
    kernels.reset_launch_counts()
    fwarm_s, pf = _sync_s(torch, lambda: exf.factorize(data))
    fprog = exf.programs["factorize"]
    fcap = (fprog.launches["finalize_fused_cuda"],
            fprog.launches["cholesky_inverse_cuda"])
    if counts() != (2 * fexp[0], 2 * fexp[1]) or fcap != fexp:
        raise AssertionError(f"fused factorize counted (K2, K1) {counts()} "
                             f"in its first call and {fcap} in its capture;"
                             f" the plan implies twice {fexp} and {fexp}")
    t_default, t_fused = _abba(torch, lambda: ex.factorize(data),
                               lambda: exf.factorize(data), 10)
    pf = exf.factorize(data)
    k2_launches = counts()[0]
    if counts() != (2 * fexp[0], 2 * fexp[1]):
        raise AssertionError(f"the replays counted launches: (K2, K1) "
                             f"{counts()}")
    if not all(torch.isfinite(p).all() for p in pf):
        raise AssertionError("fused factor has non-finite entries")
    if not all(torch.equal(p, q)
               for p, q in zip(pf, exf._factorize_eager(data))):
        raise AssertionError("the fused factorize program's pools differ "
                             "from the fused _factorize_eager's")
    pscale = max(float(p.abs().max()) for p in solver.lx)
    pool_err = max(float((p - q).abs().max()) for p, q in zip(pf, solver.lx))
    if not pool_err <= 1e-3 * pscale:
        raise AssertionError(f"fused pools differ from the default by "
                             f"{pool_err:.3e} > 1e-3 * {pscale:.3e}")
    import scipy.sparse as sp
    lpat = solver.lpat
    lf = sp.csc_matrix((exf.factor_values(pf).cpu().numpy().astype(
        np.float64), lpat.indices, lpat.indptr), shape=(a.n, a.n))
    bf = np.asarray(lf @ np.ones(a.n), dtype=np.float32)
    ferr = float(np.max(np.abs(exf.solve_lower(pf, bf).cpu().numpy() - 1)))
    if not ferr < 1e-3:
        raise AssertionError(f"fused solve_lower with b = L*1: max|1 - x| "
                             f"{ferr:.3e} >= 1e-3")
    xf = np.empty(a.n)
    xf[solver.perm] = exf.solve_spd(pf, bp).cpu().numpy()
    fres = solver.solve_residual(b, xf)
    if not fres < 1e-3:
        raise AssertionError(f"fused solve(A*1): ||Ax - b||/||b|| "
                             f"{fres:.3e} >= 1e-3")
    fsmall = CholeskySolver(generate.laplace_3d(24), cfg, device="cuda",
                            fused_finalize=True).factorize()
    fresid = fsmall.factor_residual()
    if not fresid < 1e-3:
        raise AssertionError(f"fused factor residual {fresid:.3e} >= 1e-3")
    fops = _device_ops(torch, lambda: exf.factorize(data), K2_NAMES)
    if fops["k_n"] != fexp[0]:
        raise AssertionError(f"torch.profiler saw {fops['k_n']} K2 launches "
                             f"in one replayed fused factorize; the plan "
                             f"implies {fexp[0]}")
    dops = _device_ops(torch, lambda: ex.factorize(data))
    fused = dict(
        warm_factorize_s=fwarm_s, capture_s=fprog.capture_s,
        graph_nodes=fprog.nodes,
        fused_factorize_s_min_med_max=[t_fused[0], t_fused[2], t_fused[-1]],
        default_factorize_s_min_med_max=[t_default[0], t_default[2],
                                         t_default[-1]],
        fused_gflops=plan.flops / t_fused[2] / 1e9,
        default_gflops=plan.flops / t_default[2] / 1e9,
        k2_launches_fused_path_run=k2_launches,
        k2_launches_per_replay=fexp[0], k1_launches_per_replay=fexp[1],
        fused_device_ops=fops["ops"], fused_device_ms=fops["busy_ms"],
        fused_idle_share_of_median_wall=1 - fops["busy_ms"] / (
            t_fused[2] * 1e3),
        k2_profiled_launches=fops["k_n"], k2_device_ms=fops["k_ms"],
        default_device_ops=dops["ops"], default_device_ms=dops["busy_ms"],
        pool_max_abs_diff=pool_err, pool_scale=pscale,
        solve_lower_max_err=ferr, solve_rel_residual=fres,
        factor_residual_n13824=fresid, update_delta=cfg.update_delta,
        card=card)
    print("fused", json.dumps(fused))

    # ---- 9. the forward solves -----------------------------------------
    prep_s, _ = _sync_s(torch, lambda: ex._linv_pools(solver.lx))
    prep = ex.solve_prep(solver.lx)
    bl = ex._vec(b_l)

    def fast():
        return ex._solve_lower_fast_impl(solver.lx, bl, *prep)

    def leveled():
        return ex._solve_lower_impl(solver.lx, bl)

    t_fast, t_lev = [], []
    for fn, acc in ((fast, t_fast), (leveled, t_lev), (leveled, t_lev),
                    (fast, t_fast)) * 2:
        t, x = _sync_s(torch, fn)
        err = float((x - 1.0).abs().max())
        if not err < 1e-3:
            raise AssertionError(f"{fn.__name__} solve_lower with b = L*1: "
                                 f"max|1 - x| {err:.3e} >= 1e-3")
        acc.append(t)
    fast_ops = _device_ops(torch, fast)
    lev_ops = _device_ops(torch, leveled)
    solves = dict(
        solve_prep_s=prep_s, fast_solve_lower_s_min=min(t_fast),
        leveled_solve_lower_s_min=min(t_lev),
        fast_solve_lower_s=t_fast, leveled_solve_lower_s=t_lev,
        fast_device_ops=fast_ops["ops"], fast_device_ms=fast_ops["busy_ms"],
        leveled_device_ops=lev_ops["ops"],
        leveled_device_ms=lev_ops["busy_ms"],
        card=card)
    print("solves", json.dumps(solves))

    # ---- 10. the probes, P3 at the main path's ladder sums and P2 at its
    # update products -----------------------------------------------------
    probe = _probe_phase(torch, np, kernels, plan, ex, solver.lx, gen,
                         card)

    # ---- 11. the scatter update mode at n = 110,592 -------------------
    scatter = _scatter_phase(torch, np, kernels, a, cfg, card)
    print("scatter", json.dumps(scatter))

    # ---- 12. the triangular solves at n = 110,592 on phase 4's factor --
    # (no hand-written kernel lies on this path: the counts stay at 0)
    from parsy_bench_tpu_torch.symbolic.dagplan import choose_schedule
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    l_chordal = solver.factor_csc()
    factor_csc_s = time.perf_counter() - t0
    tri = {}
    for name, tier, sched in (("supernodal", "supernodal", "auto"),
                              ("wavefront", "simplicial", "wavefront"),
                              ("coarsened", "simplicial", "coarsened")):
        rec, tri[name] = _trisolve(torch, np, name, l_chordal, SolverConfig(
            tier=tier, trisolve_schedule=sched, dtype="float32"), card)
        print("trisolve", json.dumps(rec))
    auto = choose_schedule(l_chordal, tri["wavefront"].levels)
    rows = np.array([0, a.n // 2, a.n - 1])
    pruned = [_pruned(torch, np, tri[k], rows, card)
              for k in ("supernodal", "wavefront")]
    print("pruned", json.dumps(pruned))
    del tri

    # ---- 13. a non-chordal L: the lower half of A at n = 110,592 -------
    l_lower = a if a.is_lower() else a.lower_half()
    for sched in ("wavefront", "coarsened"):
        rec, ts = _trisolve(torch, np, f"lower half of A, {sched}", l_lower,
                            SolverConfig(tier="simplicial", dtype="float32",
                                         trisolve_schedule=sched), card)
        print("trisolve", json.dumps(rec))
    auto_lower = choose_schedule(l_lower, ts.levels)
    del ts
    if any(kernels.launch_counts().values()):
        raise AssertionError(f"the triangular solves launched a hand-written "
                             f"kernel: {kernels.launch_counts()}")
    print("trisolve picks", json.dumps(dict(
        auto_factor=auto, auto_lower_half=auto_lower,
        factor_csc_s=factor_csc_s, nnz_l=int(l_chordal.nnz),
        nnz_lower_half=int(l_lower.nnz), card=card)))

    # ---- 14. the simplicial Cholesky at laplace_3d(SIMPLICIAL_GRID) ----
    simplicial, simp = _simplicial_phase(torch, np, kernels, generate, card)
    print("simplicial", json.dumps(simplicial))

    # ---- 15. the CLI ----------------------------------------------------
    print("cli", json.dumps(_cli_phase(np, card)))

    # ---- 16. the multi-device tier in rank processes, with phase 21's
    # eval beside it ------------------------------------------------------
    lref = ex.factor_values(solver.lx).cpu().numpy()
    x_fast = ex.solve_lower(solver.lx, b_l).cpu().numpy()
    with ThreadPoolExecutor(max_workers=1) as pool:
        evaluation = pool.submit(_module_run, EVAL_CMD,
                                 [*EVAL_ARGS, "--device", "cuda"],
                                 EVAL_TIMEOUT)
        multi = _multi_device_phase(torch, np, solver, cfg, lref, b_l, bp,
                                    x_fast, simp, scatter["scaling_g1_row"],
                                    card)
    evaluation = evaluation.result()
    print("multi-device phase", json.dumps(dict(
        plans_s=multi["plans_s"], launch_s=multi["launches"],
        phase_s=multi["phase_s"], card=card)))
    del simp

    # ---- 17. the dense top, the aligned-operand pool, verify_plan, the
    # analysis artifacts and the performance model on phase 4's matrix --
    last = _last_slice_phase(torch, np, kernels, a, cfg, solver, analyze_s,
                             med, b_l, x_fast, card)
    print("phase 17", json.dumps(dict(
        phase_s=last["phase_s"], peak_allocated_gb=last["peak_allocated_gb"],
        reserved_gb=last["reserved_gb"], card=card)))

    # ---- 18. the bench on the card --------------------------------------
    print("phase 18 bench", json.dumps(_bench_phase(int(a.n), med, card)))

    # ---- 19. the attribution scripts on phase 4's solver ---------------
    attr = _attribution_phase(solver, expected, prof4, card)
    print("phase 19", json.dumps(dict(phase_s=attr["phase_s"],
                                      script_s=attr["script_s"], card=card)))

    # ---- 20. the reference-scale run and scale_test ---------------------
    large = _reference_scale_phase(torch, dense, kernels,
                                   set(K1_SHAPES) | set(K1_SMALL), card)
    print("phase 20 large_run stages", json.dumps(large["stages"]))
    print("phase 20 large_run", json.dumps(large["line"]))
    print("phase 20 scale_test", json.dumps(large["scale_test"]))
    print("phase 20", json.dumps(dict(
        phase_s=large["phase_s"],
        large_run_process_s=large["large_run_process_s"],
        scale_test_process_s=large["scale_test_process_s"],
        k1_new_shapes=len(large["k1_checks"]), card=card)))

    # ---- 21. the sweep drivers, and the segment times of phases 17 and 19
    sweep = _sweep_phase(evaluation, len(plan.segments),
                         last["model"]["segments_measured_s"],
                         attr["full_s"], card)
    for ln in sweep["eval"]:
        print("phase 21 eval", json.dumps(ln))
    for r in sweep["h1_vs_coarse"]:
        print("phase 21 h1_vs_coarse", json.dumps(r))
    print("phase 21 calibrate_model", json.dumps(sweep["calibrate_model"]))
    print("phase 21 segment times", json.dumps(sweep["segment_times"]))
    print("phase 21", json.dumps(dict(
        phase_s=sweep["phase_s"], eval_process_s=sweep["eval_process_s"],
        h1_process_s=sweep["h1_process_s"],
        calibrate_process_s=sweep["calibrate_process_s"],
        segment_sum_ratio=sweep["segment_times"]["sum_ratio"],
        segment_max_ratio=sweep["segment_times"]["max_ratio"],
        segment_min_ratio=sweep["segment_times"]["min_ratio"],
        segments_same_ranking=sweep["segment_times"]["same_ranking"],
        segments_within_tol=sweep["segment_times"]["within_tol"],
        all_signs_correct=sweep["calibrate_model"]["validation"][
            "all_signs_correct"], card=card)))

    # ---- 22. result ----------------------------------------------------
    print(card)
    k2_path = [r for r in k2 if r["shape"][2] <= 64]
    rank_k1 = [r["k1_checks"] for r in multi["runs"] if "k1_checks" in r]

    def probe_entry(name, line, rec, k, **extra):
        bound_ms, bound_by = _bound(*probe["p_work"][k])
        return dict(name=name, route="cuda",
                    source="parsy_bench_tpu_torch/csrc/probes.cu",
                    replaces=line, launches=probe["plaunch"][k],
                    max_abs_err=max(r["max_abs_err"] for r in rec),
                    ms=rec[0]["ms"], plain_ms=rec[0]["plain_ms"],
                    bound_ms=bound_ms, bound_by=bound_by,
                    library_ms=probe["p_lib"][k], runs=rec, **extra)

    def summed(recs):
        """ms, plain_ms, library_ms and bound_ms of one call at each shape
        of ``recs``; bound_by of the shape with the largest bound."""
        lib = [r["library_ms"] for r in recs]
        return dict(ms=sum(r["ms"] for r in recs),
                    plain_ms=sum(r["plain_ms"] for r in recs),
                    bound_ms=sum(r["bound_ms"] for r in recs),
                    bound_by=max(recs, key=lambda r: r["bound_ms"])[
                        "bound_by"],
                    library_ms=None if None in lib else sum(lib))

    print(json.dumps({"kernels": [
        dict(name="cholesky_inverse", route="cuda",
             source="parsy_bench_tpu_torch/csrc/chol_inverse.cu",
             replaces="parsy_bench_tpu/ops/pallas_kernels.py:273",
             # the main path's run: the warm-up's launches and the
             # capture's (replays count none)
             launches=launches, launches_per_replay=k1_per_replay,
             profiled_launches_per_replay=k1_prof_n,
             # phase 3's main-path shapes and phase 16's rank shapes
             max_abs_err=max(max(r["max_abs_err_L"], r["max_abs_err_Linv"])
                             for r in k1 + rank_k1 + large["k1_checks"]),
             # one call at each main-path shape; the library time is the
             # pair cholesky_ex + solve_triangular
             **summed(k1), shapes=k1 + k1_small + k1_f64,
             # phase 16: per rank, in one factorize of each executor
             rank_launches={f"{r['executor']} G={r['G']}":
                            r["k1_launches_per_factorize_by_rank"]
                            for r in multi["runs"] if "k1_checks" in r},
             rank_shapes={f"{r['executor']} G={r['G']}": r["k1_checks"]
                          for r in multi["runs"] if "k1_checks" in r},
             # phase 17: the dense-top plan's and the restored artifact's
             # factorize, each counted from 0 (warm-up and capture)
             phase17_launches=dict(
                 top_plan_factorize=last["top_factorize"]["k1_launches_run"],
                 top_plan_per_replay=last["top_factorize"][
                     "k1_launches_per_replay"],
                 restored_artifact_factorize=last["artifact"][
                     "k1_launches_run"]),
             # phase 19: per script and mode, K1's launches per replay of
             # its programs (captures, profiler, plan)
             phase19_launches=attr["k1_launches"],
             # phase 20: the reference-scale run's K1 launches (per
             # factorize from the captures, the plan's calls, the whole
             # process's count) and the checks at its batch shapes that
             # phase 3 did not check
             phase20_launches=dict(
                 per_factorize=large["line"]["k1_launches_per_factorize"],
                 plan=large["line"]["chol_calls_per_factorize"],
                 run=large["line"]["k1_launches_run"]),
             phase20_shapes=large["k1_checks"],
             # phase 21: h1_vs_coarse's K1 launches per factorize, per
             # segment_alpha (the factorize program's capture)
             phase21_launches=sweep["k1_launches_per_alpha"]),
        dict(name="finalize_fused", route="cuda",
             source="parsy_bench_tpu_torch/csrc/finalize_fused.cu",
             replaces="parsy_bench_tpu/ops/pallas_kernels.py:235",
             launches=k2_launches, launches_per_replay=fexp[0],
             profiled_launches_per_replay=fops["k_n"],
             max_abs_err=max(r["max_abs_err"] for r in k2),
             # one call at each fused-path shape checked (c = 32)
             **summed(k2_path), shapes=k2 + [k2_leaf] + k2_f64),
        probe_entry("probe_copy", "scripts/pallas_probe.py:19",
                    [probe["precs"][0]], 0,
                    pairs_vs_library=probe["p1_pairs"]),
        # the probe's 128^3 product; the update products of one
        # factorize (the kernel is not wired into the executor: 0 launches
        # in the main path's run)
        probe_entry("probe_matmul", "scripts/pallas_probe.py:34",
                    [probe["precs"][1]], 1, main_path_launches=p2_main,
                    profiled_ms=probe["p2"]["profiled_ms"],
                    max_abs_err_vs_f64=probe["p2"]["max_abs_err_vs_f64"],
                    pairs_vs_library=probe["p2"]["pairs_vs_library"],
                    update_products=probe["products"]),
        # each run with its own bytes and bound; the ladder sums of one
        # factorize (the kernel is not wired into the executor: 0 launches
        # in the main path's run)
        probe_entry("probe_gather", "scripts/pallas_gather_probe.py:83",
                    probe["gathers"], 2, main_path_launches=p3_main,
                    flush_study=probe["flush_study"],
                    ladder=probe["ladder"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
