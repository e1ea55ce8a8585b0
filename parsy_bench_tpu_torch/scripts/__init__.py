"""The port's per-layer attribution scripts, the counterparts of the
repository's ``scripts/floor_r5.py``, ``scripts/fin_ablate.py`` and
``scripts/solve_floor.py``:

    python -m parsy_bench_tpu_torch.scripts.floor_r5 [--all-modes]
    python -m parsy_bench_tpu_torch.scripts.fin_ablate [--segment 0]
    python -m parsy_bench_tpu_torch.scripts.solve_floor [--ks 8,16,24,34]

Each runs on the card unless ``--device cpu`` is given, and prints one
JSON line with the JAX script's keys.  ``attribution`` holds what they
share: their own executor, the restore-and-time protocol and the
profiler's per-scope device time.
"""
