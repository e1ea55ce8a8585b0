"""parsy_bench_tpu_torch — the sparse direct solver in PyTorch, for one
NVIDIA H100.

A port of ``parsy_bench_tpu`` (the JAX package, kept as the reference).
It carries its own copy of the host inspector (``config``, ``core``,
``native``, ``symbolic``: ordering, etree, supernodes, plan) and imports
nothing of the JAX package.  The numeric phase (supernodal Cholesky +
triangular solves) runs on the card by default (``device="cpu"`` runs the
plain versions of the kernels), with hand-written CUDA kernels: the
batched Cholesky + inverse (``csrc/chol_inverse.cu``), the fused finalize
(``csrc/finalize_fused.cu``) and the probes (``csrc/probes.cu``, run by
``python -m parsy_bench_tpu_torch.probes``).  Imports torch and never jax.
"""

from parsy_bench_tpu_torch.config import SolverConfig
from parsy_bench_tpu_torch.core.csc import CSC
from parsy_bench_tpu_torch.models.solver import (CholeskySolver,
                                                 NotPositiveDefiniteError)

__all__ = ["CSC", "CholeskySolver", "NotPositiveDefiniteError",
           "SolverConfig"]
