"""The benchmark's tests: ``python -m pytest benchmark/tests -q`` from the
checkout's root.  They run on the CPU at tiny grids; the tests marked
``card`` decide inside the test whether a CUDA card is there and skip
without one (on the card: ``python3 -m pytest benchmark/tests -q -m card``).
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")
