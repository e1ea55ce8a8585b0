"""The port's own inspector against the JAX package's: the port keeps
copies of ``config``, ``core``, ``native`` and the symbolic modules, and
they must give the same arrays, bit for bit, on the suite matrices.

Each case runs twice: with the native C++ library of each package (the
port builds its own copy of ``native/src/symbolic.cpp``), and with both
packages' native library set to None, so the NumPy specifications run.
"""
import importlib

import numpy as np
import pytest

import parsy_bench_tpu.native as jnative
import parsy_bench_tpu_torch.native as pnative
from parsy_bench_tpu.core import generate as jgen
from parsy_bench_tpu_torch.core import generate as pgen
from test_torch_native import reload_native_libs

# a test process that lost a native library's first-build race
# loads it now, so both packages' inspectors run native
reload_native_libs()


def _mods(pkg):
    # import_module: the JAX package's symbolic/__init__ re-exports
    # functions under the module names (``etree``)
    return [importlib.import_module(f"{pkg}.symbolic.{m}")
            for m in ("etree", "colcounts", "ordering", "supernodes")]


jet, jcc, jord, jsn = _mods("parsy_bench_tpu")
pet, pcc, por, psn = _mods("parsy_bench_tpu_torch")

MATRICES = ["tiny", "bcsstk14ish", "ecology_small", "apache_small"]


def _use_native(monkeypatch, on):
    """Keep both native libraries, or set both to None.  The symbolic
    modules bind the library at import, so their binding is set too."""
    if on:
        assert jnative.lib is not None and pnative.lib is not None
        return
    for mod in (jnative, pnative):
        monkeypatch.setattr(mod, "lib", None)
    for mod in (jet, jcc, jord, jsn, pet, pcc, por, psn):
        monkeypatch.setattr(mod, "_native", None)


def _equal(x, y):
    x, y = np.asarray(x), np.asarray(y)
    return x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("name", MATRICES)
def test_inspector_matches_jax(name, native, monkeypatch):
    _use_native(monkeypatch, native)
    a, aj = pgen.SUITE[name](), jgen.SUITE[name]()
    assert type(a).__module__ == "parsy_bench_tpu_torch.core.csc"
    assert a.n == aj.n
    for x, y in ((a.indptr, aj.indptr), (a.indices, aj.indices),
                 (a.data, aj.data)):
        assert _equal(x, y)
    for method in ("natural", "amd", "nd"):
        perm = por.compute_ordering(a, method)
        assert _equal(perm, jord.compute_ordering(aj, method)), method
    # the solver's analyze chain on the nested-dissection order
    ap, apj = a.permute(perm), aj.permute(perm)
    parent = pet.etree(ap)
    assert _equal(parent, jet.etree(apj))
    cc = pcc.col_counts(ap, parent)
    assert _equal(cc, jcc.col_counts(apj, parent))
    post = pet.postorder(parent, weights=cc)
    assert _equal(post, jet.postorder(parent, weights=cc))
    ap, apj = ap.permute(post), apj.permute(post)
    parent = pet.etree(ap)
    assert _equal(parent, jet.etree(apj))
    cc = pcc.col_counts(ap, parent)
    assert _equal(cc, jcc.col_counts(apj, parent))
    assert _equal(pet.tree_levels(parent), jet.tree_levels(parent))
    pat = pcc.symbolic_pattern(ap, parent)
    patj = jcc.symbolic_pattern(apj, parent)
    assert _equal(pat.indptr, patj.indptr)
    assert _equal(pat.indices, patj.indices)
    # supernode detection: fundamental supernodes, relaxed amalgamation,
    # the width split and the row patterns
    assert _equal(psn.fundamental_supernodes(parent, cc),
                  jsn.fundamental_supernodes(parent, cc))
    part = psn.build_partition(ap, parent, cc)
    partj = jsn.build_partition(apj, parent, cc)
    assert part.nsuper == partj.nsuper
    for f in ("sptr", "col2sup", "sparent"):
        assert _equal(getattr(part, f), getattr(partj, f)), f
    rows = psn.supernodal_rows(pat, part)
    rowsj = jsn.supernodal_rows(patj, partj)
    assert all(_equal(x, y) for x, y in zip(rows, rowsj))
    if native:
        rows = psn.supernodal_rows_from_etree(ap, parent, part)
        rowsj = jsn.supernodal_rows_from_etree(apj, parent, partj)
        assert all(_equal(x, y) for x, y in zip(rows, rowsj))
