"""Factor state carried between the JAX executor and the port.

Both executors keep the factor as per-width-class packed pools of shape
(R/8, 8c) on the same ``SupernodalPlan`` layout, so a factor moves across
as numpy arrays, element for element.  The plan itself is numpy on both
sides and needs no converter.
"""
from __future__ import annotations

import numpy as np
import torch

from parsy_bench_tpu_torch.ops.supernodal import resolve_device, torch_dtype


def pools_from_numpy(pools, device, dtype) -> tuple:
    """Per-class packed pools (e.g. ``np.asarray`` of each array the JAX
    ``SupernodalExecutor.factorize`` returns) -> the port's pools."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype)
    return tuple(torch.tensor(np.asarray(p), device=dev, dtype=dt)
                 for p in pools)


def pools_to_numpy(pools) -> list:
    """The port's pools -> per-class numpy arrays of the same shape."""
    return [p.detach().cpu().numpy() for p in pools]
