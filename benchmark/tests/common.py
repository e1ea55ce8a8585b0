"""What the benchmark's tests share: the parsed ``BENCHMARK.json`` and a
cell cut to a tiny grid."""
import json
import os
import time

from benchmark import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 2**31 + 12345


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def tiny_cell(name: str, side: int = 8) -> harness.Cell:
    """The cell ``name`` with its grid cut to ``side`` nodes an axis."""
    cell = harness.find_cell(bench(), name)
    m = cell.config["matrix"]
    m["dims"] = [side] * len(m["dims"])
    return cell


def run_tiny(name, traced=False, seconds=0.5, make_system=None, side=8,
             seed=SEED) -> dict:
    cell = tiny_cell(name, side)
    kw = {} if make_system is None else {"make_system": make_system}
    return harness.run(cell, seed, seconds, traced, "cpu",
                       time.perf_counter(), **kw)
