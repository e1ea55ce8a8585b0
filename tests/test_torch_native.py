"""The native inspector library from a cold build, and a helper for the
port's test files.

Each package builds its C++ library with g++ at first import, into its own
``native/_build/``.  The test processes of one run import both packages at
once, so their first builds race.  The port's builder takes a file lock
around the build (``parsy_bench_tpu_torch/native/build.py``); the JAX
package's builder does not, and a process that loses its race there ends
with ``parsy_bench_tpu.native.lib = None``.  ``reload_native_libs`` loads
such a library again once the race is over, so that the tests that compare
the two packages' inspectors compare native with native.

    from test_torch_native import reload_native_libs
    reload_native_libs()
"""
import importlib
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

#: each package's symbolic modules that bind the library at import
_BINDERS = {
    "parsy_bench_tpu": ("etree", "colcounts", "ordering", "supernodes",
                        "plan"),
    "parsy_bench_tpu_torch": ("etree", "colcounts", "ordering",
                              "supernodes"),
}


def reload_native_libs(tries=5):
    """Load each package's native library again where its first import
    left ``native.lib`` None, up to ``tries`` times, and bind the result
    to ``native.lib`` and to ``_native`` of the symbolic modules.  After a
    lost build race the library exists, so a retry only loads it; where
    g++ is missing every try fails and the NumPy versions run, as
    before."""
    for pkg, mods in _BINDERS.items():
        native = importlib.import_module(f"{pkg}.native")
        for k in range(tries):
            if native.lib is not None:
                break
            try:
                native.lib = importlib.import_module(
                    f"{pkg}.native.build").load()
            except Exception:  # noqa: BLE001 - a real failure stays None
                time.sleep(0.2 * (k + 1))
        # import_module: the JAX package's symbolic/__init__ re-exports
        # functions under some of the module names (``etree``)
        for m in mods:
            importlib.import_module(f"{pkg}.symbolic.{m}")._native = \
                native.lib


_BUILD_PY = (Path(__file__).resolve().parents[1] / "parsy_bench_tpu_torch"
             / "native" / "build.py")

#: one process of the race: load build.py alone (no package import, so no
#: torch), point it at the shared build directory, wait for the common
#: start time, build and load
_RACER = """
import importlib.util, sys, time
spec = importlib.util.spec_from_file_location("pbt_native_build", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
mod._BUILD = sys.argv[2]
time.sleep(max(0.0, float(sys.argv[3]) - time.time()))
mod.load()
print("loaded")
"""


def test_concurrent_cold_builds_all_load(tmp_path):
    """``nproc`` processes build the port's native library at once into
    one fresh directory: every one of them must get a library."""
    if shutil.which("g++") is None:
        pytest.skip("the native library is built with g++")
    nproc = 6
    build = tmp_path / "_build"
    start = time.time() + 3.0
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RACER, str(_BUILD_PY), str(build),
         repr(start)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for _ in range(nproc)]
    results = [p.communicate(timeout=300) + (p.returncode,) for p in procs]
    lost = [err.strip().splitlines()[-1:] for out, err, rc in results
            if rc != 0 or out.strip() != "loaded"]
    assert not lost, f"{len(lost)} of {nproc} processes got no library: " \
                     f"{lost}"
    assert len(list(build.glob("libpbt_*.so"))) == 1
    assert not list(build.glob("*.tmp*"))


def test_reload_binds_the_library_everywhere(monkeypatch):
    """A package whose ``native.lib`` is None after its first import gets
    its library back, on ``native`` and on every symbolic module."""
    for pkg, mods in _BINDERS.items():
        native = importlib.import_module(f"{pkg}.native")
        if native.lib is None:
            pytest.skip(f"{pkg}'s native library does not build here")
    for pkg, mods in _BINDERS.items():
        monkeypatch.setattr(importlib.import_module(f"{pkg}.native"), "lib",
                            None)
        for m in mods:
            monkeypatch.setattr(
                importlib.import_module(f"{pkg}.symbolic.{m}"), "_native",
                None)
    reload_native_libs()
    for pkg, mods in _BINDERS.items():
        lib = importlib.import_module(f"{pkg}.native").lib
        assert lib is not None
        for m in mods:
            assert importlib.import_module(f"{pkg}.symbolic.{m}")._native \
                is lib
