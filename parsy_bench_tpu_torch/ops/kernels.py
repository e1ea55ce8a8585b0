"""Hand-written Hopper kernels and their PyTorch wrappers.

Counterpart of ``parsy_bench_tpu/ops/pallas_kernels.py``.  Each wrapper
checks its inputs, allocates the outputs with ``torch.empty``, launches
its kernel on the current CUDA stream, raises if the launch failed, and
adds one to its plain-integer ``launches`` count.  Inside a
``torch.cuda.graph`` capture (``ops/graphs.py``) the launch goes into the
graph and is counted once, at capture: a program's count is its
launches per replay, and replays advance no count.  It takes CUDA tensors
only: the plain versions (``ops/dense.py``, ``probes.py``) serve CPU
tensors, and the callers choose between the two
(``ops/supernodal.chol_inverse`` and ``finalize_fused``, the ``probe_*``
functions of ``probes.py``).

    K1  cholesky_inverse_cuda   csrc/chol_inverse.cu
    K2  finalize_fused_cuda     csrc/finalize_fused.cu
    P1  probe_copy_cuda         csrc/probes.cu
    P2  probe_matmul_cuda       csrc/probes.cu
    P3  gather_sum_cuda         csrc/probes.cu (``probe_gather_cuda``
                                is the TPU probe's (G, 8, c) view of it)

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
    "pbt_matmul_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "pbt_gather_sum_f32": [_P, _P, _P, _I, _I, _I, _I, _P],
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
    (replaces ``scripts/pallas_probe.py`` ``_copy_kernel_result``),
    launched as a programmatic dependent launch: its launch overlaps the
    tail of the kernel before it, and it reads and writes only after that
    kernel has finished."""
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


def probe_matmul_cuda(a: torch.Tensor, b: torch.Tensor,
                      trans_b: bool = False):
    """Probe P2: C = a @ op(b) in f32 on the tensor cores (3xTF32, f32
    accuracy), by the kernels of ``csrc/probes.cu`` (replaces
    ``scripts/pallas_probe.py`` ``_matmul_kernel_result``): 16-row strips
    on ``mma.sync``, or 64-row tiles on ``wgmma`` where M >= 64, N >= 96,
    64 <= K <= 136 and b is (N, K).  The probe's a (M, K) @ b (K, N), or
    batched: a (L, M, K) @ b (L, K, N) -> (L, M, N); with ``trans_b`` b
    is (N, K) or (L, N, K) and the product is a @ b^T, the form of the
    update products of ``ops/supernodal.update_block`` (A B_raw^T, Chat
    S^T).  Shapes and the int32 offsets are checked before the device,
    so a mis-shaped call is refused wherever its tensors lie."""
    kdim = -1 if trans_b else -2
    if (a.dim() not in (2, 3) or b.dim() != a.dim()
            or a.shape[:-2] != b.shape[:-2] or a.shape[-1] != b.shape[kdim]):
        form = "(N, K)" if trans_b else "(K, N)"
        raise ValueError(f"expected (M, K) @ {form}, both 2-D or both with "
                         f"one batch dimension of the same length, got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    L = a.shape[0] if a.dim() == 3 else 1
    M, K = a.shape[-2:]
    N = b.shape[-2] if trans_b else b.shape[-1]
    if max(L * M * K, L * K * N, L * M * N) >= 2**31:
        raise ValueError("operands too large for int32 offsets")
    _check_cuda("probe_matmul_cuda", a, b)
    for t in (a, b):
        _check_dtype("probe_matmul_cuda", t, (torch.float32,))
    out = torch.empty(a.shape[:-2] + (M, N), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    if K == 0:
        return out.zero_()
    _launch(f"matmul at (L, M, N, K) = ({L}, {M}, {N}, {K})",
            _load().pbt_matmul_f32, a.device, a.data_ptr(), b.data_ptr(),
            out.data_ptr(), L, M, N, K, int(bool(trans_b)))
    probe_matmul_cuda.launches += 1
    return out


probe_matmul_cuda.launches = 0


def gather_sum_cuda(pool: torch.Tensor, idx: torch.Tensor, per: int):
    """Probe P3, the gather-and-sum: pool (rows, w) f32 with w % 4 == 0,
    idx (G * per,) int32 -> (G, w), group g summing the rows
    ``pool[idx[g*per + k]]`` over k < per; a kernel of ``csrc/probes.cu``
    (replaces ``scripts/pallas_gather_probe.py`` ``pallas_gather``).  The
    executor's ladder sums ``call[gi[t]].sum(1)`` are this function with
    pool = call and idx = ``gi[t].flatten()``.  An index outside
    [0, rows) reads nothing and makes its group NaN."""
    _check_cuda("gather_sum_cuda", pool, idx)
    _check_dtype("gather_sum_cuda", pool, (torch.float32,))
    _check_dtype("gather_sum_cuda", idx, (torch.int32,))
    if idx.dim() != 1 or pool.dim() != 2:
        raise ValueError(f"expected pool (rows, w) and idx (G * per,), got "
                         f"{tuple(pool.shape)} and {tuple(idx.shape)}")
    rows, w = pool.shape
    per = int(per)
    if per < 1 or idx.numel() % per:
        raise ValueError(f"{idx.numel()} indices are not groups of {per}")
    if w % 4 or pool.data_ptr() % 16:
        raise ValueError("pool rows must be a multiple of 4 floats wide and "
                         "start 16-byte aligned")
    G = idx.numel() // per
    if rows >= 2**31 or 32 * G * -(-w // 128) >= 2**31:
        raise ValueError(f"pool ({rows}, {w}) with {G} groups exceeds the "
                         f"int32 counts")
    out = torch.empty((G, w), dtype=pool.dtype, device=pool.device)
    if G == 0 or w == 0:
        return out
    _launch(f"gather_sum at (G, per, w) = ({G}, {per}, {w})",
            _load().pbt_gather_sum_f32, pool.device, pool.data_ptr(),
            idx.data_ptr(), out.data_ptr(), rows, w, G, per)
    gather_sum_cuda.launches += 1
    return out


gather_sum_cuda.launches = 0


def probe_gather_cuda(pool8: torch.Tensor, idx: torch.Tensor, per: int):
    """The TPU probe's view of ``gather_sum_cuda``: pool8 (rows8, 8c) f32
    packed pool, idx (nidx,) int32 packed-row starts -> (nidx / per, 8,
    c)."""
    if pool8.dim() != 2 or pool8.shape[1] % 8:
        raise ValueError(f"expected pool8 (rows8, 8c), got "
                         f"{tuple(pool8.shape)}")
    out = gather_sum_cuda(pool8, idx, per)
    return out.view(out.shape[0], 8, pool8.shape[1] // 8)


#: the counted wrappers, by module attribute (so that a stand-in bound to
#: the same name is counted too)
_WRAPPERS = ("cholesky_inverse_cuda", "finalize_fused_cuda",
             "probe_copy_cuda", "probe_matmul_cuda", "gather_sum_cuda")


def launch_counts() -> dict:
    """Each wrapper's ``launches`` count, by wrapper name."""
    return {name: globals()[name].launches for name in _WRAPPERS}


def reset_launch_counts() -> None:
    """Set every wrapper's ``launches`` count to 0."""
    for name in _WRAPPERS:
        globals()[name].launches = 0
