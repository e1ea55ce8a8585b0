"""Native (C++) fast path for the host-side symbolic engine.

The reference keeps its whole inspector in C++ (cholesky/LSparsity.h etc.);
here the C++ library accelerates the irregular pointer-chasing kernels while
the NumPy implementations in ``parsy_bench_tpu_torch.symbolic`` remain the
specification and fallback.  Built lazily with g++ via ``build.py``; loaded
through ctypes (no pybind11 in this environment).

``lib`` is None when the shared library is unavailable — callers must treat
it as optional.

The port's own copy of ``parsy_bench_tpu/native/__init__.py`` (the
reference); only the package in its imports differs.
"""
from __future__ import annotations

lib = None

try:  # pragma: no cover - exercised implicitly everywhere
    from parsy_bench_tpu_torch.native.build import load
    lib = load()
except Exception:  # noqa: BLE001 - any build/load failure => Python fallback
    lib = None
