"""parsy_bench_tpu_torch — the sparse direct solver in PyTorch, for one
NVIDIA H100.

A port of ``parsy_bench_tpu`` (the JAX package, kept as the reference):
the host inspector (ordering, etree, supernodes, plan) is shared with it,
and the numeric phase (supernodal Cholesky + triangular solves) runs on
an explicit torch device, with hand-written CUDA kernels on the card: the
batched Cholesky + inverse (``csrc/chol_inverse.cu``), the fused finalize
(``csrc/finalize_fused.cu``) and the probes (``csrc/probes.cu``, run by
``python -m parsy_bench_tpu_torch.probes``).  Imports torch and never jax.
"""

from parsy_bench_tpu.config import SolverConfig
from parsy_bench_tpu.core.csc import CSC
from parsy_bench_tpu_torch.models.solver import (CholeskySolver,
                                                 NotPositiveDefiniteError)

__all__ = ["CSC", "CholeskySolver", "NotPositiveDefiniteError",
           "SolverConfig"]
