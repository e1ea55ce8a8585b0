"""Multi-device execution layer, one rank process per device of the
group (``comm.launch``, ``comm.Group``; the JAX package's mesh axis
``"p"``):

* :class:`DistExecutor` — the ownership-partitioned distributed tier
  (per-rank pools, boundary-only ragged-psum exchange; SURVEY §7E);
* :class:`ShardedSupernodalExecutor` / :class:`ShardedSimplicialExecutor`
  — the simpler update-stream-sharded tier (replicated pools).
"""
from parsy_bench_tpu_torch.parallel.dist import DistExecutor
from parsy_bench_tpu_torch.parallel.sharded import (
    ShardedSimplicialExecutor, ShardedSupernodalExecutor)

__all__ = ["DistExecutor", "ShardedSimplicialExecutor",
           "ShardedSupernodalExecutor"]
