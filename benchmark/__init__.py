"""The benchmark of ``parsy_bench_tpu_torch``: ``python3 benchmark/run.py``
runs one cell of ``BENCHMARK.json`` (see ``harness.py``)."""
