"""Build both packages' native inspector libraries once, before any other
test module is imported, so that no test process loses a first-build race.

Why this file sorts first: pytest collects a directory's entries in name
order, and ``_prebuild`` sorts before every ``test_*.py`` file of
``tests/`` (``_`` is below the lower-case letters).  Every worker of a
parallel run (pytest-xdist) collects, and so imports, all test files in
that order before any test runs; this module is therefore the first test
module each worker imports.  Keep the directory's name below ``test_``.

What it does at import: it takes one exclusive ``fcntl.flock`` on
``parsy_bench_tpu_torch/native/_build/jax_prebuild.lock`` and, holding
it, imports ``parsy_bench_tpu.native`` and ``parsy_bench_tpu_torch.native``
(``prebuild``).  The JAX package's loader builds only when its ``.so`` is
missing (``parsy_bench_tpu/native/build.py``), so the first worker builds
and the others, once the lock is theirs, find the library built.

Why it is needed: the JAX package's ``build.py`` takes no lock, and after a
build it deletes every other ``libpbt_*`` file of its directory, which
includes the half-written ``.tmp<pid>`` files of workers still compiling.
A worker that loses that race ends with ``parsy_bench_tpu.native.lib =
None``, and ``tests/test_native.py``, which binds the library when it is
imported, then skips all of its tests.  The lock file lives in the port's
build directory and is not named ``libpbt_*``, so that cleanup never
touches it.  The port's own ``build.py`` locks on its own; taking it under
the same lock costs nothing.
"""
import fcntl
import importlib
import os
import shutil
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

_ROOT = Path(__file__).resolve().parents[2]
_LOCK = _ROOT / "parsy_bench_tpu_torch" / "native" / "_build" / \
    "jax_prebuild.lock"


def prebuild(lock_path, loaders):
    """Call each of ``loaders`` while holding an exclusive lock on
    ``lock_path``; returns their results."""
    os.makedirs(os.path.dirname(lock_path), exist_ok=True)
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return [load() for load in loaders]


_LIBS = prebuild(str(_LOCK), [
    lambda: importlib.import_module("parsy_bench_tpu.native").lib,
    lambda: importlib.import_module("parsy_bench_tpu_torch.native").lib])


def test_both_native_libraries_load():
    """The import above left each package a library, so the modules that
    bind it at import (``tests/test_native.py``) find it."""
    if shutil.which("g++") is None:
        pytest.skip("the native libraries are built with g++")
    assert all(lib is not None for lib in _LIBS)
    assert importlib.import_module("parsy_bench_tpu.native").lib is _LIBS[0]


#: one process of the race: the JAX package's build.py loaded alone (no
#: package import), pointed at the shared fresh build directory, through
#: ``prebuild`` (its source is prepended), all starting at one time
_RACER = """
import importlib.util, sys, time
spec = importlib.util.spec_from_file_location("pbt_jax_build", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
mod._BUILD = sys.argv[2]
time.sleep(max(0.0, float(sys.argv[3]) - time.time()))
prebuild(sys.argv[2] + "/jax_prebuild.lock", [mod.load])
print("loaded")
"""


def test_concurrent_cold_jax_builds_all_load(tmp_path):
    """Six processes build the JAX package's library at once into one
    fresh directory through the locked prebuild: every one of them must
    get a library, one ``.so`` must remain, and no ``.tmp`` file."""
    if shutil.which("g++") is None:
        pytest.skip("the native library is built with g++")
    import inspect
    nproc = 6
    build = tmp_path / "_build"
    code = ("import fcntl, os\n"
            + textwrap.dedent(inspect.getsource(prebuild)) + _RACER)
    jax_build = _ROOT / "parsy_bench_tpu" / "native" / "build.py"
    start = time.time() + 3.0
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(jax_build), str(build),
         repr(start)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for _ in range(nproc)]
    results = [p.communicate(timeout=300) + (p.returncode,) for p in procs]
    lost = [err.strip().splitlines()[-1:] for out, err, rc in results
            if rc != 0 or out.strip() != "loaded"]
    assert not lost, f"{len(lost)} of {nproc} processes got no library: " \
                     f"{lost}"
    assert len(list(build.glob("libpbt_*.so"))) == 1
    assert not list(build.glob("*.tmp*"))
