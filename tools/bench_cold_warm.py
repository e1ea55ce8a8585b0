#!/usr/bin/env python3
"""The port's bench (``python -m parsy_bench_tpu_torch.bench``) twice as a
subprocess on the card, as ``chip_smoke.py`` phase 18 runs it:

    python3 tools/bench_cold_warm.py

From a checkout with no ``_build/`` directories the first run is the cold
one: g++ builds the native inspector library when the bench imports the
package, before any of its timers, and nvcc builds the CUDA kernels in
``kernel_build_s``, before the analyze.  The second run finds both
built.  Prints the card line (nvidia-smi) and, per run, the bench's line
with the process's seconds (``chip_smoke._bench_phase``).  This process
imports none of the package before the first run.  Needs a CUDA card.
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.modules["jax"] = None

import chip_smoke  # noqa: E402


#: where the two builds land (git-ignored)
BUILDS = (os.path.join(ROOT, "parsy_bench_tpu_torch", "native", "_build"),
          os.path.join(ROOT, "parsy_bench_tpu_torch", "csrc", "_build"))


def main() -> int:
    card = chip_smoke._card()
    print(card)
    for _ in range(2):
        run = ("warm" if any(os.path.exists(d) for d in BUILDS)
               else "cold")
        rec = chip_smoke._bench_phase(110592, None, card)
        print(run, json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
