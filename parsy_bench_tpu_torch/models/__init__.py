from parsy_bench_tpu_torch.models.solver import (CholeskySolver,
                                                 NotPositiveDefiniteError,
                                                 TriangularSolver)

__all__ = ["CholeskySolver", "NotPositiveDefiniteError", "TriangularSolver"]
