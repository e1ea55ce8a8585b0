from parsy_bench_tpu_torch.models.solver import (CholeskySolver,
                                                 NotPositiveDefiniteError)

__all__ = ["CholeskySolver", "NotPositiveDefiniteError"]
