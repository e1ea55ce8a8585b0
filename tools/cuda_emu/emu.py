"""The port's CUDA kernels run on the CPU, for correctness only.

Compiles a kernel source of ``parsy_bench_tpu_torch/csrc`` (K1:
``chol_inverse.cu``, K2: ``finalize_fused.cu``, both on
``chol_blocked.cuh``) with g++ against the stand-in ``cuda_runtime.h``
beside this file (one std::thread per CUDA thread, real barriers and
shuffles, shared memory poisoned with NaN) and calls its C symbols through
ctypes.  It finds indexing and barrier faults in a kernel without a card;
it says nothing about its speed.

    python -m pytest tests/test_torch_k1_emu.py tests/test_torch_k2_emu.py

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
}


def build(source, out_dir) -> ctypes.CDLL:
    """Rewrite the two ``<<<grid, threads, smem, s>>>`` launches of
    ``csrc/<source>`` into ``emu_launch`` calls, compile it with g++ into
    ``out_dir`` and return the loaded library, its symbols typed."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    src = (CSRC / source).read_text()
    src, n = re.subn(r"(\w+<T>)<<<([^,]+), ([^,]+), (\w+), s>>>\(",
                     r"emu_launch(\1, \2, \3, \4, ", src)
    if n != 2:
        raise RuntimeError(f"expected 2 kernel launches in {source}, found "
                           f"{n}")
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
