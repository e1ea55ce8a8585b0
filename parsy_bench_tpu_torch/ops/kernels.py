"""Hand-written Hopper kernels and their PyTorch wrappers.

Counterpart of ``parsy_bench_tpu/ops/pallas_kernels.py``.  Each wrapper
checks its inputs, allocates the outputs with ``torch.empty``, launches
its kernel on the current CUDA stream, raises if the launch failed, and
adds one to its plain-integer ``launches`` count.  It takes CUDA tensors
only: the plain versions (``ops/dense.py``) serve CPU tensors, and the
callers choose between the two (``ops/supernodal.chol_inverse``).

The kernels are built (``ops/build.py``) and loaded on the first launch,
never at import.
"""
from __future__ import annotations

import ctypes

import torch

_lib = None


def _load():
    global _lib
    if _lib is None:
        from parsy_bench_tpu_torch.ops.build import build
        lib = ctypes.CDLL(build())
        for name in ("pbt_chol_inverse_f32", "pbt_chol_inverse_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


#: widest block the kernel takes: c * (c + 1) f64 values must fit the
#: 227 KB of shared memory one block may use
MAX_WIDTH = 128


def cholesky_inverse_cuda(D: torch.Tensor):
    """Batched masked-SPD Cholesky + triangular inverse on the card:
    D (P, c, c) -> (L, Linv), lower triangular, zeros above the diagonal.
    Kernel: ``csrc/chol_inverse.cu`` (replaces
    ``pallas_kernels.cholesky_inverse_pallas``)."""
    if not isinstance(D, torch.Tensor) or D.device.type != "cuda":
        raise ValueError("cholesky_inverse_cuda takes a CUDA tensor; "
                         "use ops.dense.cholesky_inverse on the CPU")
    if D.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"cholesky_inverse_cuda takes float32 or float64, "
                        f"got {D.dtype}")
    if D.dim() != 3 or D.shape[1] != D.shape[2]:
        raise ValueError(f"expected a (P, c, c) batch, got {tuple(D.shape)}")
    if not D.is_contiguous():
        raise ValueError("cholesky_inverse_cuda takes a contiguous tensor")
    P, c, _ = D.shape
    if not 1 <= c <= MAX_WIDTH:
        raise ValueError(f"block width {c} outside [1, {MAX_WIDTH}]")
    if P >= 2**31:
        raise ValueError(f"batch of {P} blocks exceeds the grid limit")
    L = torch.empty_like(D)
    Linv = torch.empty_like(D)
    if P == 0:
        return L, Linv
    lib = _load()
    fn = (lib.pbt_chol_inverse_f32 if D.dtype == torch.float32
          else lib.pbt_chol_inverse_f64)
    stream = torch.cuda.current_stream(D.device).cuda_stream
    with torch.cuda.device(D.device):
        err = fn(D.data_ptr(), L.data_ptr(), Linv.data_ptr(), P, c, stream)
    if err != 0:
        raise RuntimeError(f"chol_inverse kernel launch failed: CUDA error "
                           f"{err} at (P, c) = ({P}, {c})")
    cholesky_inverse_cuda.launches += 1
    return L, Linv


cholesky_inverse_cuda.launches = 0
