"""Hand-written Hopper kernels and their PyTorch wrappers.

Counterpart of ``parsy_bench_tpu/ops/pallas_kernels.py``.  Each wrapper
checks its inputs, allocates the outputs with ``torch.empty``, launches
its kernel on the current CUDA stream, raises if the launch failed, and
adds one to its plain-integer ``launches`` count.  It takes CUDA tensors
only: the plain versions (``ops/dense.py``, ``probes.py``) serve CPU
tensors, and the callers choose between the two
(``ops/supernodal.chol_inverse`` and ``finalize_fused``, the ``probe_*``
functions of ``probes.py``).

    K1  cholesky_inverse_cuda   csrc/chol_inverse.cu
    K2  finalize_fused_cuda     csrc/finalize_fused.cu
    P1  probe_copy_cuda         csrc/probes.cu
    P2  probe_matmul_cuda       csrc/probes.cu
    P3  probe_gather_cuda       csrc/probes.cu

The kernels are built (``ops/build.py``) and loaded on the first launch,
never at import.
"""
from __future__ import annotations

import ctypes

import torch

_lib = None


_P, _I = ctypes.c_void_p, ctypes.c_int
#: C symbol -> argument types (pointers and the stream pointer-wide)
_SIGNATURES = {
    "pbt_chol_inverse_f32": [_P, _P, _P, _I, _I, _P],
    "pbt_chol_inverse_f64": [_P, _P, _P, _I, _I, _P],
    "pbt_finalize_fused_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "pbt_finalize_fused_f64": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "pbt_probe_copy_f32": [_P, _P, _I, _P],
    "pbt_probe_matmul_f32": [_P, _P, _P, _I, _I, _I, _P],
    "pbt_probe_gather_f32": [_P, _P, _P, _I, _I, _I, _I, _P],
}


def _load():
    global _lib
    if _lib is None:
        from parsy_bench_tpu_torch.ops.build import build
        lib = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_cuda(name, *tensors):
    """Raise unless every tensor is a contiguous CUDA tensor, all on one
    device."""
    for t in tensors:
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{name} takes CUDA tensors; the plain "
                             f"version serves CPU tensors")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: tensors on {tensors[0].device} and "
                             f"{t.device}")


def _check_dtype(name, t, dtypes):
    if t.dtype not in dtypes:
        raise TypeError(f"{name} takes {[str(d) for d in dtypes]}, got "
                        f"{t.dtype}")


def _launch(name, fn, device, *args):
    """Call a kernel's C launcher on the current stream of ``device``;
    raise on a nonzero CUDA error."""
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


#: widest block K1 and K2 take: the blocked routine's f64 tiles (with K2's
#: row stage beside them) must fit the 227 KB of shared memory one block
#: may use
MAX_WIDTH = 128

_FLOATS = (torch.float32, torch.float64)


def cholesky_inverse_cuda(D: torch.Tensor):
    """Batched masked-SPD Cholesky + triangular inverse on the card:
    D (P, c, c) -> (L, Linv), lower triangular, zeros above the diagonal.
    Kernel K1: ``csrc/chol_inverse.cu`` (replaces
    ``pallas_kernels.cholesky_inverse_pallas``)."""
    _check_cuda("cholesky_inverse_cuda", D)
    _check_dtype("cholesky_inverse_cuda", D, _FLOATS)
    if D.dim() != 3 or D.shape[1] != D.shape[2]:
        raise ValueError(f"expected a (P, c, c) batch, got {tuple(D.shape)}")
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
    _launch(f"chol_inverse at (P, c) = ({P}, {c})", fn, D.device,
            D.data_ptr(), L.data_ptr(), Linv.data_ptr(), P, c)
    cholesky_inverse_cuda.launches += 1
    return L, Linv


cholesky_inverse_cuda.launches = 0

#: K2's target grid: about two waves of CTAs on the H100's 132 SMs
_K2_CTAS = 264


def finalize_chunks(P: int, H: int, c: int) -> int:
    """Row chunks K2 cuts each lane of a bucket (P, H, c) into: tall,
    narrow buckets are cut (each chunk factors its lane's top again) so
    that the grid fills about ``_K2_CTAS`` CTAs."""
    if c <= 32:
        # one warp a chunk, four a CTA (csrc/finalize_fused.cu
        # kWarpsPerCta); at least the eight rows a warp stages at a time
        units, min_rows = 4 * _K2_CTAS, 8
    else:
        # one CTA a chunk, whose blocked chain costs as much as a few
        # hundred staged rows: only buckets much taller than wide are cut
        units, min_rows = _K2_CTAS, 256
    return max(1, min(-(-units // P), -(-H // min_rows)))


def finalize_fused_cuda(blk: torch.Tensor, w: torch.Tensor, cnt: int,
                        nchunk: int | None = None):
    """The whole per-bucket finalize on the card: blk (P, H, c) window
    block, w (P,) int32 logical widths, cnt true lanes -> the lane-masked
    diff (P, H, c) to add onto the window.  Kernel K2:
    ``csrc/finalize_fused.cu`` (replaces
    ``pallas_kernels.finalize_fused_pallas``).  ``nchunk``, the row chunks
    per lane, defaults to ``finalize_chunks``; other counts are for
    measuring that choice."""
    _check_cuda("finalize_fused_cuda", blk, w)
    _check_dtype("finalize_fused_cuda", blk, _FLOATS)
    _check_dtype("finalize_fused_cuda", w, (torch.int32,))
    if blk.dim() != 3 or w.shape != (blk.shape[0],):
        raise ValueError(f"expected blk (P, H, c) and w (P,), got "
                         f"{tuple(blk.shape)} and {tuple(w.shape)}")
    P, H, c = blk.shape
    if not 1 <= c <= MAX_WIDTH:
        raise ValueError(f"block width {c} outside [1, {MAX_WIDTH}]")
    if H < c or H * c >= 2**31 or P >= 2**31:
        raise ValueError(f"bucket (P, H, c) = ({P}, {H}, {c}) needs "
                         f"c <= H, H*c < 2^31 and P < 2^31")
    cnt = int(cnt)
    diff = torch.empty_like(blk)
    if P == 0:
        return diff
    nchunk = finalize_chunks(P, H, c) if nchunk is None else int(nchunk)
    if nchunk < 1 or P * nchunk >= 2**31:
        raise ValueError(f"{P} lanes in {nchunk} chunks exceed the grid "
                         f"limit")
    lib = _load()
    fn = (lib.pbt_finalize_fused_f32 if blk.dtype == torch.float32
          else lib.pbt_finalize_fused_f64)
    _launch(f"finalize_fused at (P, H, c) = ({P}, {H}, {c})", fn,
            blk.device, blk.data_ptr(), w.data_ptr(), diff.data_ptr(), P, H,
            c, cnt, nchunk)
    finalize_fused_cuda.launches += 1
    return diff


finalize_fused_cuda.launches = 0


def probe_copy_cuda(x: torch.Tensor):
    """Probe P1: a copy of an f32 tensor by a kernel of ``csrc/probes.cu``
    (replaces ``scripts/pallas_probe.py`` ``_copy_kernel_result``)."""
    _check_cuda("probe_copy_cuda", x)
    _check_dtype("probe_copy_cuda", x, (torch.float32,))
    if x.numel() >= 2**31:
        raise ValueError(f"{x.numel()} elements exceed the int32 count")
    y = torch.empty_like(x)
    _launch("probe_copy", _load().pbt_probe_copy_f32, x.device,
            x.data_ptr(), y.data_ptr(), x.numel())
    probe_copy_cuda.launches += 1
    return y


probe_copy_cuda.launches = 0


def probe_matmul_cuda(a: torch.Tensor, b: torch.Tensor):
    """Probe P2: a (M, K) @ b (K, N) in f32 on the CUDA cores, by a kernel
    of ``csrc/probes.cu`` (replaces ``scripts/pallas_probe.py``
    ``_matmul_kernel_result``)."""
    _check_cuda("probe_matmul_cuda", a, b)
    for t in (a, b):
        _check_dtype("probe_matmul_cuda", t, (torch.float32,))
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"expected (M, K) @ (K, N), got {tuple(a.shape)} "
                         f"@ {tuple(b.shape)}")
    M, K = a.shape
    N = b.shape[1]
    if max(M * K, K * N, M * N) >= 2**31:
        raise ValueError("matrices too large for int32 offsets")
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    _launch("probe_matmul", _load().pbt_probe_matmul_f32, a.device,
            a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K)
    probe_matmul_cuda.launches += 1
    return out


probe_matmul_cuda.launches = 0


def probe_gather_cuda(pool8: torch.Tensor, idx: torch.Tensor, per: int):
    """Probe P3: pool8 (rows8, 8c) f32 packed pool, idx (nidx,) int32 ->
    (nidx / per, 8, c), group g summing the packed rows
    ``pool8[idx[g*per + k]]`` over k < per; a kernel of ``csrc/probes.cu``
    (replaces ``scripts/pallas_gather_probe.py`` ``pallas_gather``).  An
    index outside [0, rows8) reads nothing and makes its group NaN."""
    _check_cuda("probe_gather_cuda", pool8, idx)
    _check_dtype("probe_gather_cuda", pool8, (torch.float32,))
    _check_dtype("probe_gather_cuda", idx, (torch.int32,))
    if idx.dim() != 1 or pool8.dim() != 2:
        raise ValueError(f"expected pool8 (rows8, 8c) and idx (nidx,), got "
                         f"{tuple(pool8.shape)} and {tuple(idx.shape)}")
    rows8, width = pool8.shape
    per = int(per)
    if per < 1 or idx.numel() % per:
        raise ValueError(f"{idx.numel()} indices are not groups of {per}")
    if width % 32 or pool8.data_ptr() % 16 or rows8 >= 2**31:
        raise ValueError("pool8 rows must be 8c wide with c a multiple of 4 "
                         "and start 16-byte aligned")
    G = idx.numel() // per
    out = torch.empty((G, 8, width // 8), dtype=pool8.dtype,
                      device=pool8.device)
    if G == 0:
        return out
    _launch("probe_gather", _load().pbt_probe_gather_f32, pool8.device,
            pool8.data_ptr(), idx.data_ptr(), out.data_ptr(), rows8, width,
            G, per)
    probe_gather_cuda.launches += 1
    return out


probe_gather_cuda.launches = 0
