"""The port's CUDA kernels run on the CPU, for correctness only.

Compiles a kernel source of ``parsy_bench_tpu_torch/csrc`` (K1:
``chol_inverse.cu``, K2: ``finalize_fused.cu``, both on
``chol_blocked.cuh``; P1-P3: ``probes.cu``) with g++ against the
stand-in ``cuda_runtime.h`` beside this file (one std::thread per CUDA
thread, real barriers and shuffles, shared memory poisoned with NaN,
P2's tensor-core instructions from the PTX fragment tables) and calls
its C symbols through ctypes.  It finds indexing and barrier faults in a
kernel without a card; it says nothing about its speed.

    python -m pytest tests/test_torch_k1_emu.py tests/test_torch_k2_emu.py \
        tests/test_torch_p2_emu.py tests/test_torch_p3_emu.py

builds each kernel into a temporary directory and holds it against the
plain versions and the JAX package.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
CSRC = HERE.parents[1] / "parsy_bench_tpu_torch" / "csrc"

#: kernel source -> its C symbols' argument types
_P, _I = ctypes.c_void_p, ctypes.c_int
SOURCES = {
    "chol_inverse.cu": {"pbt_chol_inverse_f32": [_P] * 3 + [_I, _I, _P],
                        "pbt_chol_inverse_f64": [_P] * 3 + [_I, _I, _P]},
    "finalize_fused.cu": {
        "pbt_finalize_fused_f32": [_P] * 3 + [_I] * 5 + [_P],
        "pbt_finalize_fused_f64": [_P] * 3 + [_I] * 5 + [_P]},
    "probes.cu": {"pbt_probe_copy_f32": [_P, _P, _I, _P],
                  "pbt_matmul_f32": [_P] * 3 + [_I] * 5 + [_P],
                  "pbt_gather_sum_f32": [_P] * 3 + [_I] * 4 + [_P]},
}


def build(source, out_dir) -> ctypes.CDLL:
    """Rewrite every ``<<<grid, threads, smem, s>>>`` launch of
    ``csrc/<source>`` into an ``emu_launch`` call, compile it with g++
    into ``out_dir`` and return the loaded library, its symbols typed."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    src = (CSRC / source).read_text()
    launches = src.count("<<<")
    src, n = re.subn(r"(\w+(?:<T>)?)<<<([^,]+), ([^,]+), (\w+), s>>>\(",
                     r"emu_launch(\1, \2, \3, \4, ", src)
    if n == 0 or n != launches:
        raise RuntimeError(f"{source}: {n} of its {launches} kernel "
                           f"launches are in the form <<<grid, threads, "
                           f"smem, s>>>")
    # the stand-in header defines the shared buffer itself
    src = src.replace("extern __shared__ __align__(16) unsigned char "
                      "smem_raw[];", "")
    stem = source.split(".")[0]
    cpp = out / f"{stem}_emu.cpp"
    cpp.write_text(src)
    so = out / f"lib{stem}_emu.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC",
                    "-pthread", "-Wno-unknown-pragmas", f"-I{HERE}",
                    f"-I{CSRC}", "-o", str(so), str(cpp)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SOURCES[source].items():
        getattr(lib, name).argtypes = argtypes
    return lib


def chol_inverse(lib, D):
    """(L, Linv) of a (P, c, c) float32 or float64 array, from the
    emulated K1; the outputs start as 7.0 so an unwritten entry shows."""
    D = np.ascontiguousarray(D)
    L = np.full_like(D, 7.0)
    Linv = np.full_like(D, 7.0)
    fn = (lib.pbt_chol_inverse_f32 if D.dtype == np.float32
          else lib.pbt_chol_inverse_f64)
    err = fn(D.ctypes.data, L.ctypes.data, Linv.ctypes.data, D.shape[0],
             D.shape[1], None)
    if err != 0:
        raise RuntimeError(f"emulated K1 returned error {err}")
    return L, Linv


def finalize_fused(lib, blk, w, cnt, nchunk):
    """diff (P, H, c) of a float32 or float64 bucket from the emulated K2,
    each lane's rows cut into ``nchunk`` chunks; diff starts as 7.0 so an
    unwritten entry shows."""
    blk = np.ascontiguousarray(blk)
    w = np.ascontiguousarray(w, dtype=np.int32)
    diff = np.full_like(blk, 7.0)
    P, H, c = blk.shape
    fn = (lib.pbt_finalize_fused_f32 if blk.dtype == np.float32
          else lib.pbt_finalize_fused_f64)
    err = fn(blk.ctypes.data, w.ctypes.data, diff.ctypes.data, P, H, c,
             int(cnt), int(nchunk), None)
    if err != 0:
        raise RuntimeError(f"emulated K2 returned error {err}")
    return diff


def probe_copy(lib, x):
    """y = x from the emulated P1, for a float32 array whose pointer may
    be offset from 16 bytes; y starts as 7.0."""
    y = np.full_like(x, 7.0)
    err = lib.pbt_probe_copy_f32(x.ctypes.data, y.ctypes.data, x.size, None)
    if err != 0:
        raise RuntimeError(f"emulated P1 returned error {err}")
    return y


def matmul(lib, a, b, trans_b=False):
    """C[l] = a[l] @ b[l] (b[l]^T with ``trans_b``) from the emulated P2:
    a (L, M, K) or (M, K), b (L, K, N) or (L, N, K) with ``trans_b`` (2-D
    with a 2-D a), float32; C starts as 7.0 so an unwritten entry
    shows."""
    a = np.ascontiguousarray(a, dtype=np.float32)
    b = np.ascontiguousarray(b, dtype=np.float32)
    flat = a.ndim == 2
    if flat:
        a, b = a[None], b[None]
    L, M, K = a.shape
    N = b.shape[1] if trans_b else b.shape[2]
    c = np.full((L, M, N), 7.0, dtype=np.float32)
    err = lib.pbt_matmul_f32(a.ctypes.data, b.ctypes.data, c.ctypes.data,
                             L, M, N, K, int(trans_b), None)
    if err != 0:
        raise RuntimeError(f"emulated P2 returned error {err}")
    return c[0] if flat else c


def gather_sum(lib, pool, idx, per):
    """(G, w) group sums of the rows pool[idx[g*per + k]] from the
    emulated P3; pool (rows, w) float32 16-byte aligned, idx int32; the
    output starts as 7.0 so an unwritten entry shows."""
    pool = np.ascontiguousarray(pool, dtype=np.float32)
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    if pool.ctypes.data % 16:
        raise ValueError("pool must start 16-byte aligned")
    rows, w = pool.shape
    out = np.full((idx.size // per, w), 7.0, dtype=np.float32)
    err = lib.pbt_gather_sum_f32(pool.ctypes.data, idx.ctypes.data,
                                 out.ctypes.data, rows, w, idx.size // per,
                                 per, None)
    if err != 0:
        raise RuntimeError(f"emulated P3 returned error {err}")
    return out
