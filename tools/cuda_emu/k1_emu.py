"""K1's CUDA source run on the CPU, for correctness only.

Compiles ``parsy_bench_tpu_torch/csrc/chol_inverse.cu`` with g++ against
the stand-in ``cuda_runtime.h`` beside this file (one std::thread per CUDA
thread, real barriers and shuffles, shared memory poisoned with NaN) and
calls its C symbols through ctypes.  It finds indexing and barrier faults
in the kernel without a card; it says nothing about its speed.

    python -m pytest tests/test_torch_k1_emu.py

builds it into a temporary directory and holds it against the JAX
package's dense chain at every width class, in f32 and f64.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
CSRC = HERE.parents[1] / "parsy_bench_tpu_torch" / "csrc"


def build(out_dir) -> Path:
    """Rewrite chol_inverse.cu's two launches into ``emu_launch`` calls,
    compile it with g++ into ``out_dir`` and return the library's path."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    src = (CSRC / "chol_inverse.cu").read_text()
    src, n = re.subn(r"(\w+<T>)<<<([^,]+), ([^,]+), (\w+), s>>>\(",
                     r"emu_launch(\1, \2, \3, \4, ", src)
    if n != 2:
        raise RuntimeError(f"expected 2 kernel launches in chol_inverse.cu,"
                           f" found {n}")
    # the stand-in header defines the shared buffer itself
    src = src.replace("extern __shared__ __align__(16) unsigned char "
                      "smem_raw[];", "")
    cpp = out / "chol_inverse_emu.cpp"
    cpp.write_text(src)
    so = out / "libk1_emu.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC",
                    "-pthread", "-Wno-unknown-pragmas", f"-I{HERE}",
                    f"-I{CSRC}", "-o", str(so), str(cpp)],
                   check=True, capture_output=True, text=True)
    return so


def load(so):
    lib = ctypes.CDLL(str(so))
    for name in ("pbt_chol_inverse_f32", "pbt_chol_inverse_f64"):
        getattr(lib, name).argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib


def chol_inverse(lib, D):
    """(L, Linv) of a (P, c, c) float32 or float64 array, from the
    emulated kernel; the outputs start as 7.0 so an unwritten entry
    shows."""
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
