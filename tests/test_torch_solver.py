"""The port's CholeskySolver end to end on the CPU, its chol_inverse
dispatch, and its independence from jax.

The CUDA kernel itself needs the card: ``chip_smoke.py`` builds it and
holds it against its plain version there.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp

import jax

# as in every test file that shares a worker with JAX f64 tests
jax.config.update("jax_enable_x64", True)

import torch

from parsy_bench_tpu.config import SolverConfig
from parsy_bench_tpu.core import generate
from parsy_bench_tpu.core.csc import CSC
from parsy_bench_tpu_torch import CholeskySolver, NotPositiveDefiniteError
from parsy_bench_tpu_torch.ops import dense, kernels, supernodal
from test_torch_native import reload_native_libs

# a test process that lost a native library's first-build race
# loads it now, so both packages' inspectors run native
reload_native_libs()

# one intra-op thread per test process: the suite runs several pytest
# workers at once, and torch's default pool (one thread per core) in each
# of them oversubscribes the cores many times over on these small ops
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _solver(a, **kw):
    cfg = SolverConfig(tier="supernodal", ordering="amd", dtype="float64")
    return CholeskySolver(a, cfg.replace(**kw), device="cpu")


@pytest.mark.parametrize("name", ["tiny", "bcsstk14ish", "ecology_small",
                                  "apache_small"])
def test_suite_f64_factor_and_solve(name):
    a = generate.SUITE[name]()
    s = _solver(a).factorize()
    assert s.factor_ok()
    assert s.factor_residual() < 1e-10
    x = s.solve(a.spd_rhs_for_ones())
    assert isinstance(x, np.ndarray) and x.shape == (a.n,)
    assert np.max(np.abs(x - 1.0)) < 1e-8
    if a.n <= 2000:
        lref = np.linalg.cholesky(s.ap.symmetrize_from_lower().to_dense())
        assert np.max(np.abs(s.factor_csc().to_dense() - lref)) < 1e-8


def test_f32_refinement():
    """f32 factor: the reference bar, and refinement sweeps shrink the
    solve residual."""
    a = generate.SUITE["bcsstk14ish"]()
    b = a.spd_rhs_for_ones()
    res = []
    for steps in (0, 2):
        s = _solver(a, dtype="float32", refine_steps=steps).factorize()
        assert s.factor_residual() < 1e-3
        res.append(s.solve_residual(b, s.solve(b)))
    assert res[0] < 1e-4
    assert res[1] < res[0] / 10


def test_new_values_same_pattern():
    a = generate.SUITE["tiny"]()
    s = _solver(a).factorize()
    a2 = CSC(a.n, a.indptr, a.indices, a.data * 2.0)
    b = a.spd_rhs_for_ones()
    x = s.factorize(a2).solve(b)
    assert np.max(np.abs(x - 0.5)) < 1e-10


def test_indefinite_matrix_raises():
    a = generate.SUITE["bcsstk14ish"]()
    m = a.symmetrize_from_lower().to_scipy().tolil()
    m[50, 50] = -abs(m[50, 50]) - 1.0
    bad = CSC.from_scipy(sp.tril(m.tocsc(), 0).tocsc())
    s = _solver(bad)
    with pytest.raises(NotPositiveDefiniteError):
        s.factorize()
    assert not s.factor_ok()
    assert _solver(a).factorize().factor_ok()


def test_unported_options_raise():
    a = generate.SUITE["tiny"]()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        CholeskySolver(a, SolverConfig(tier="simplicial"), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        CholeskySolver(a, SolverConfig(tier="supernodal", verify=True),
                       device="cpu")
    with pytest.raises(ValueError):
        _solver(a, dtype="float16")


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CholeskySolver(generate.SUITE["tiny"](),
                       SolverConfig(tier="supernodal"), device="cuda")


def test_tf32_refused_on_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        CholeskySolver(generate.SUITE["tiny"](),
                       SolverConfig(tier="supernodal"), device="cuda:0")


def test_chol_inverse_dispatch_cpu():
    """A CPU tensor goes to the plain version and the kernel's launch
    count does not move; the kernel wrapper refuses CPU tensors."""
    rng = np.random.default_rng(2)
    A = rng.standard_normal((3, 32, 32))
    D = torch.as_tensor(A @ A.transpose(0, 2, 1) + 32 * np.eye(32))
    before = kernels.cholesky_inverse_cuda.launches
    L, Linv = supernodal.chol_inverse(D)
    Lr, Linvr = dense.cholesky_inverse(D)
    assert torch.equal(L, Lr) and torch.equal(Linv, Linvr)
    assert kernels.cholesky_inverse_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.cholesky_inverse_cuda(D)
    assert kernels.cholesky_inverse_cuda.launches == before


def test_package_imports_no_jax():
    """In a process where jax cannot be imported, the port imports,
    factorizes and solves, and loads no module of jax and none of the JAX
    package (``parsy_bench_tpu`` or anything under it)."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import numpy as np\n"
        "import parsy_bench_tpu_torch as pt\n"
        "from parsy_bench_tpu_torch.core import generate\n"
        "a = generate.SUITE['tiny']()\n"
        "s = pt.CholeskySolver(a, pt.SolverConfig(tier='supernodal',\n"
        "    dtype='float64'), device='cpu').factorize()\n"
        "x = s.solve(a.spd_rhs_for_ones())\n"
        "assert np.max(np.abs(x - 1)) < 1e-8\n"
        "f = pt.CholeskySolver(a, pt.SolverConfig(tier='supernodal',\n"
        "    dtype='float64'), device='cpu', fused_finalize=True)\n"
        "f.factorize()\n"
        "y = f.executor.solve_lower(f.lx, a.spd_rhs_for_ones())\n"
        "assert np.isfinite(y.numpy()).all()\n"
        "from parsy_bench_tpu_torch import probes\n"
        "assert probes.probe_copy(y).equal(y)\n"
        "bad = [m for m in sys.modules if (m.startswith(('jax', 'jaxlib',\n"
        "    'parsy_bench_tpu.')) or m == 'parsy_bench_tpu')\n"
        "    and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imported_modules(path):
    """Every module an ``import`` or ``from ... import`` statement names
    anywhere in the file (inside functions too)."""
    import ast
    with open(path) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


def test_chip_smoke_imports_nothing_of_the_jax_package():
    """chip_smoke.py imports the port inside main(), so importing it as a
    module checks nothing: its import statements are read instead."""
    names = _imported_modules(os.path.join(_REPO, "chip_smoke.py"))
    assert "parsy_bench_tpu_torch" in {n.split(".")[0] for n in names}
    bad = [n for n in names if n.split(".")[0] in ("parsy_bench_tpu", "jax",
                                                  "jaxlib")]
    assert not bad, bad


def test_default_device_is_the_card(monkeypatch):
    """Without ``device`` the solver and the executor ask for the card, so
    on a host without CUDA they raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from parsy_bench_tpu_torch import SolverConfig as PortConfig
    from parsy_bench_tpu_torch.core import generate as port_generate
    a = port_generate.SUITE["tiny"]()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CholeskySolver(a)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CholeskySolver(a, PortConfig(tier="supernodal"))
    plan = CholeskySolver(a, PortConfig(tier="supernodal"),
                          device="cpu").plan
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        supernodal.SupernodalExecutor(plan, "float64")
