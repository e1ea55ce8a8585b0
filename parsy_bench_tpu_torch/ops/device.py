"""The device and dtype an executor runs on, and its plan checks, shared
by the executors (``ops/{supernodal,simplicial,dagsolve}.py``)."""
from __future__ import annotations

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def torch_dtype(dtype) -> torch.dtype:
    """A torch float dtype from a name, numpy dtype or torch dtype."""
    if isinstance(dtype, torch.dtype):
        if dtype in _DTYPES.values():
            return dtype
    else:
        name = np.dtype(dtype).name
        if name in _DTYPES:
            return _DTYPES[name]
    raise ValueError(f"unsupported dtype {dtype!r}: float32 or float64")


def resolve_device(device) -> torch.device:
    """The torch device the caller named; raises when it is a CUDA device
    on a machine without CUDA (there is no CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is "
                               f"not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: cpu or cuda")
    return dev


def refuse_tf32(device: torch.device) -> None:
    """Raise where products on ``device`` would run in TF32: the reference
    computes every product in full f32 (TF32 costs ~1e-3 in a factor)."""
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True: TF32 products "
            "cost ~1e-3 in the factor; set it to False")


def require(ok, msg) -> None:
    """The executors' construction-time plan checks: every window, slice
    and gather a plan implies must lie in bounds (JAX clamps them)."""
    if not ok:
        raise ValueError(f"plan out of bounds: {msg}")
