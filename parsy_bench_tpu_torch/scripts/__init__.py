"""The port's drivers of the solver that sit outside the package, the
counterparts of the repository's ``scripts/``:

    python -m parsy_bench_tpu_torch.scripts.floor_r5 [--all-modes]
    python -m parsy_bench_tpu_torch.scripts.fin_ablate [--segment 0]
    python -m parsy_bench_tpu_torch.scripts.solve_floor [--ks 8,16,24,34]
    python -m parsy_bench_tpu_torch.scripts.large_run [out.json] [grid]
    python -m parsy_bench_tpu_torch.scripts.scale_test [k] [ordering] [iters]
    python -m parsy_bench_tpu_torch.scripts.eval <matrices> [--trisolve]
    python -m parsy_bench_tpu_torch.scripts.h1_vs_coarse [grid] [ordering]
    python -m parsy_bench_tpu_torch.scripts.calibrate_model [grid] [out.json]
    python -m parsy_bench_tpu_torch.scripts.scaling [grid] [out.json]
    python -m parsy_bench_tpu_torch.scripts.calibrate [--quick]

Each runs on the card unless ``--device cpu`` is given.  The per-layer
attribution scripts (``floor_r5``, ``fin_ablate``, ``solve_floor``) print
one JSON line with the JAX script's keys; ``attribution`` holds what they
share: their own executor, the restore-and-time protocol and the
profiler's per-scope device time.  The reference-scale scripts
(``large_run``, ``scale_test``) print the JAX scripts' lines, and
``large_run`` writes its line to a file.  The sweep scripts run the
port's ``cli.py`` over the JAX script's tier x ordering x width sweep
(``eval``), sweep ``segment_alpha`` on the captured factorize
(``h1_vs_coarse``), and fit the card's ``ChipModel`` and check its
ranking of three knob variants against the card's own interleaved
timings (``calibrate_model``).  ``scaling`` runs the distributed
factorize and solve at G = 1, 2, 4 and 8 (G rank processes of
``parallel/``) and writes the JAX script's artifact; ``calibrate`` prints
the card's ceilings in the units of ``ChipModel``'s fields (dispatch,
row gather and scatter, stream, batched product and lane, chain step),
each body captured once and replayed.
"""
