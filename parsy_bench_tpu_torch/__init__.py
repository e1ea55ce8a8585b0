"""parsy_bench_tpu_torch — the sparse direct solver in PyTorch, for one
NVIDIA H100.

A port of ``parsy_bench_tpu`` (the JAX package, kept as the reference):
the host inspector (ordering, etree, supernodes, plan) is shared with it,
and the numeric phase (supernodal Cholesky + triangular solves) runs on
an explicit torch device, with a hand-written CUDA kernel for the batched
Cholesky + inverse on the card (``csrc/chol_inverse.cu``).  Imports torch
and never jax.
"""

from parsy_bench_tpu.config import SolverConfig
from parsy_bench_tpu.core.csc import CSC
from parsy_bench_tpu_torch.models.solver import (CholeskySolver,
                                                 NotPositiveDefiniteError)

__all__ = ["CSC", "CholeskySolver", "NotPositiveDefiniteError",
           "SolverConfig"]
