from parsy_bench_tpu_torch.core.csc import CSC
from parsy_bench_tpu_torch.core import generate

__all__ = ["CSC", "generate"]
