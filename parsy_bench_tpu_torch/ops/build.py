"""Build the package's CUDA kernels with nvcc at first use.

Every ``csrc/*.cu`` file is compiled by hand, one ``nvcc`` per source, all
started together, and the objects are linked into one shared library with
a plain C interface (loaded with ctypes by ``ops/kernels.py``):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c -o <name>.o csrc/<name>.cu   (each)
    nvcc -shared -o csrc/_build/libpbt_cuda_<srchash>.so *.o

The library name carries a hash of the sources, the build lands through
an atomic rename, and stale builds of older sources are removed.  The
compiler's output (``-Xptxas -v``: registers, shared memory and spills per
kernel) is kept beside the library as ``.log``.  Importing this module
runs nothing; ``build()`` needs ``nvcc`` (``PATH`` or
``/usr/local/cuda/bin``) and raises when it is missing or fails.
"""
from __future__ import annotations

import glob
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(CSRC, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _source_tag(sources) -> str:
    h = hashlib.sha256()
    for path in sources:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise FileNotFoundError(
        "nvcc not found on PATH or at /usr/local/cuda/bin/nvcc: the CUDA "
        "kernels can only be built on a machine with the CUDA toolkit")


def build() -> str:
    """Path of the built kernel library, compiling it if the sources
    changed since the last build."""
    sources = _sources()
    cu = [s for s in sources if s.endswith(".cu")]
    stem = f"libpbt_cuda_{_source_tag(sources)}"
    so = os.path.join(BUILD_DIR, stem + ".so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tmp = so + f".tmp{os.getpid()}"
    objs = [os.path.join(BUILD_DIR, f"{stem}_{os.path.basename(src)[:-3]}"
                         f".{os.getpid()}.o") for src in cu]
    # one compiler per source, all running at once
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(cu, objs)]
    log = []
    try:
        for src, proc in zip(cu, procs):
            out, _ = proc.communicate()
            log.append(f"== {os.path.basename(src)}\n{out}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src} (exit "
                                   f"{proc.returncode}):\n{out}")
        link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {link.returncode})"
                               f":\n{link.stdout}\n{link.stderr}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    with open(os.path.join(BUILD_DIR, stem + ".log"), "w") as f:
        f.write("".join(log))
    os.replace(tmp, so)
    # stale builds of older source revisions are dead weight
    for name in os.listdir(BUILD_DIR):
        if name.startswith("libpbt_cuda_") and not name.startswith(stem):
            try:
                os.remove(os.path.join(BUILD_DIR, name))
            except OSError:
                pass
    return so


def build_log(so: str) -> str:
    """The compiler output kept beside a library built by ``build()``."""
    path = so[:-len(".so")] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()
