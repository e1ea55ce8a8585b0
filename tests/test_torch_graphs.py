"""The port's captured programs and bench.py's entry points against the JAX
package (CPU, small).

* ``factorize_segmented`` at ``group`` 1, 3 and all segments equals the
  JAX ``factorize_segmented`` with as many programs, and is bit-equal to
  the port's own ``factorize``; ``factorize_loop`` and ``solve_loop``
  (fast and leveled plans) equal the JAX ones; ``profile_segments`` has
  the JAX keys and per-segment fields;
* the aliasing contract: results of one call survive the next, and each
  factor gets its own Linv pools;
* a wrong A length raises; the fused executor runs the same programs;
* ``ops/graphs.Program`` on the CPU calls its closure every run.

On the CPU the programs' closures run without capture (``ops/graphs.py``);
``chip_smoke.py`` holds the captured graphs against ``_factorize_eager``
on the card.  The matrices are the JAX tests' own
(tests/test_supernodal.py:135, tests/test_dense.py:99); inputs are numpy
from a seed.  Bars: 1e-3 of the pool scale in f32, 1e-10 in f64.  The
JAX side stays small: one JAX compile per grouping.
"""
import copy
import functools

import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import torch

from parsy_bench_tpu.config import SolverConfig
from parsy_bench_tpu.core import generate
from parsy_bench_tpu.models import CholeskySolver as JaxCholeskySolver
from parsy_bench_tpu.ops.supernodal import (
    SupernodalExecutor as JaxSupernodalExecutor)
from parsy_bench_tpu_torch import CholeskySolver
from parsy_bench_tpu_torch.ops import graphs, kernels
from parsy_bench_tpu_torch.ops.supernodal import SupernodalExecutor
from test_torch_native import reload_native_libs

# a test process that lost a native library's first-build race
# loads it now, so both packages' inspectors run native
reload_native_libs()

# one intra-op thread per test process (see tests/test_torch_supernodal.py)
torch.set_num_threads(1)

#: matrix -> dtype
DTYPES = {"apache_small": "float32", "bcsstk14ish": "float64"}
#: the keys of the JAX ``profile_segments`` records
#: (parsy_bench_tpu/ops/supernodal.py:1381-1385)
JAX_PROFILE_KEYS = {"segment", "steps", "upd_buckets", "fin_buckets",
                    "wslice", "median_s"}


@functools.lru_cache(maxsize=None)
def _solvers(name):
    """(port solver, JAX solver) on one matrix, not factorized."""
    a = generate.SUITE[name]()
    cfg = SolverConfig(tier="supernodal", dtype=DTYPES[name])
    return CholeskySolver(a, cfg, device="cpu"), JaxCholeskySolver(a, cfg)


@functools.lru_cache(maxsize=None)
def _jax_segmented(name, group):
    """The JAX ``factorize_segmented`` pools and its program count."""
    _, ref = _solvers(name)
    pools = ref.executor.factorize_segmented(ref.ap.data, group=group)
    return [np.asarray(p) for p in pools], len(ref.executor._grp_fns)


def _group(name, group):
    return (len(_solvers(name)[0].plan.segments) if group == "all"
            else group)


def _assert_close(name, pools, ref):
    tol = (1e-10 if DTYPES[name] == "float64"
           else 1e-3 * max(np.abs(p).max() for p in ref))
    assert len(pools) == len(ref)
    for p, q in zip(pools, ref):
        p = p.numpy()
        assert p.shape == q.shape and p.dtype == q.dtype
        assert np.max(np.abs(p - q)) <= tol


def _bit_equal(pools, ref):
    return len(pools) == len(ref) and all(torch.equal(p, q)
                                          for p, q in zip(pools, ref))


@pytest.mark.parametrize("group", [1, 3, "all"])
def test_factorize_segmented_matches_jax(group):
    """f32 on apache_small, against the JAX call at the same grouping."""
    name = "apache_small"
    port, _ = _solvers(name)
    ex = port.executor
    g = _group(name, group)
    pools = ex.factorize_segmented(port.ap.data, g)
    ref, nprog = _jax_segmented(name, g)
    _assert_close(name, pools, ref)
    assert len(ex.group_bounds(g)) == nprog
    assert _bit_equal(pools, ex.factorize(port.ap.data))


@pytest.mark.parametrize("group", [1, 3, "all"])
def test_factorize_segmented_f64_matches_jax(group):
    """f64 on bcsstk14ish, each grouping against the JAX call at group 3
    (JAX's groupings are bit-identical, tests/test_supernodal.py:135)."""
    name = "bcsstk14ish"
    port, _ = _solvers(name)
    ex = port.executor
    pools = ex.factorize_segmented(port.ap.data, _group(name, group))
    _assert_close(name, pools, _jax_segmented(name, 3)[0])
    assert _bit_equal(pools, ex.factorize(port.ap.data))
    assert _bit_equal(pools, ex._factorize_eager(port.ap.data))


@pytest.mark.parametrize("group", [1, 2, 3, 4, 5])
def test_group_bounds_are_jax_s(group):
    """The programs of a grouping run JAX's ``range(0, nseg, group)``
    segment ranges (parsy_bench_tpu/ops/supernodal.py:729-730), in
    order."""
    port, _ = _solvers("apache_small")
    ex = port.executor
    nseg = len(port.plan.segments)
    bounds = ex.group_bounds(group)
    assert bounds == [(lo, min(lo + group, nseg))
                      for lo in range(0, nseg, group)]
    assert [lo for lo, _ in bounds] == [0] + [hi for _, hi in bounds[:-1]]
    ex.factorize_segmented(port.ap.data, group)
    assert all(f"segments[{lo}:{hi}]" in ex.programs for lo, hi in bounds)


def test_group_below_one_raises():
    port, _ = _solvers("apache_small")
    with pytest.raises(ValueError, match="group 0 < 1"):
        port.executor.factorize_segmented(port.ap.data, 0)


def test_factorize_loop_matches_jax():
    name = "bcsstk14ish"
    port, ref = _solvers(name)
    ex = port.executor
    pools = ex.factorize_loop(port.ap.data, 3)
    jpools = ref.executor.factorize_loop(ref.ap.data, 3)
    _assert_close(name, pools, [np.asarray(p) for p in jpools])
    assert _bit_equal(pools, ex.factorize(port.ap.data))


@pytest.mark.parametrize("plan", ["fast", "leveled"])
def test_solve_loop_matches_jax(plan):
    """solve_loop(lx, b, 2) on the port's factor, in both packages: the
    fast forward solve, and the leveled one on a plan without the fast
    solve's tables."""
    port, ref = _solvers("bcsstk14ish")
    ex, jex = port.executor, ref.executor
    if plan == "leveled":
        pp, jp = copy.copy(port.plan), copy.copy(ref.plan)
        pp.bmap = jp.bmap = None
        ex = SupernodalExecutor(pp, "float64", "cpu")
        jex = JaxSupernodalExecutor(jp, dtype="float64")
    assert ex._has_fast_solve == jex._has_fast_solve == (plan == "fast")
    lx = ex.factorize(port.ap.data)
    b = np.random.default_rng(7).standard_normal(port.a.n)
    x = ex.solve_loop(lx, b, 2)
    xj = np.asarray(jex.solve_loop(tuple(jnp.asarray(p.numpy()) for p in lx),
                                   b, 2))
    assert np.max(np.abs(x.numpy() - xj)) <= 1e-10 * max(1.0,
                                                          np.abs(xj).max())
    assert torch.equal(x, ex.solve_lower(lx, b))


@pytest.mark.parametrize("name", ["apache_small", "bcsstk14ish"])
def test_profile_segments_has_jax_fields(name):
    port, ref = _solvers(name)
    ex = port.executor
    lx = ex.factorize(port.ap.data)
    b = np.random.default_rng(8).standard_normal(port.a.n)
    x0 = ex.solve_lower(lx, b)
    out = ex.profile_segments(port.ap.data, iters=2, reps=2)
    assert len(out) == len(ref.plan.segments)
    for i, (r, seg) in enumerate(zip(out, ref.plan.segments)):
        assert set(r) == JAX_PROFILE_KEYS
        assert (r["segment"], r["steps"], r["upd_buckets"],
                r["fin_buckets"]) == (i, seg.nsteps, len(seg.upd),
                                      len(seg.fin))
        assert r["wslice"] == list(seg.wslice)
        assert r["median_s"] > 0
    # the profile overwrote the static pools: a solve on the earlier
    # factor copies it in again
    assert torch.equal(ex.solve_lower(lx, b), x0)
    assert _bit_equal(ex.factorize(port.ap.data), lx)


def test_results_are_not_aliased():
    port, _ = _solvers("bcsstk14ish")
    ex = port.executor
    a = port.ap.data
    lx1 = ex.factorize(a)
    keep = [p.clone() for p in lx1]
    lx2 = ex.factorize(4.0 * a)
    assert _bit_equal(lx1, keep)
    assert _bit_equal(lx2, ex._factorize_eager(4.0 * a))
    _, l1, _ = ex.solve_prep(lx1)
    keep_l = [x.clone() for x in l1]
    _, l2, _ = ex.solve_prep(lx2)
    assert _bit_equal(l1, keep_l) and not _bit_equal(l1, l2)
    b = np.random.default_rng(9).standard_normal(port.a.n)
    x1 = ex.solve_lower(lx1, b)
    x2 = ex.solve_lower(lx2, b)
    x1b = ex.solve_lower(lx1, b)
    assert torch.equal(x1, x1b) and x1.data_ptr() != x1b.data_ptr()
    # L(4A) = 2 L(A)
    assert torch.max(torch.abs(x2 - x1 / 2)) <= 1e-10 * float(x1.abs().max())
    assert torch.equal(x1, ex._solve_lower_fast_impl(
        lx1, ex._vec(b), None, ex._linv_pools(lx1), ((), ())))
    s1 = ex.solve_spd(lx1, b)
    ex.solve_spd(lx2, b)
    assert torch.equal(ex.solve_spd(lx1, b), s1)


@pytest.mark.parametrize("entry", ["factorize", "factorize_segmented",
                                   "factorize_loop", "profile_segments",
                                   "_factorize_eager"])
def test_wrong_a_length_raises(entry):
    port, _ = _solvers("apache_small")
    ex = port.executor
    args = {"factorize_segmented": (2,), "factorize_loop": (2,)}
    with pytest.raises(ValueError, match="A values"):
        getattr(ex, entry)(port.ap.data[:-1], *args.get(entry, ()))


def test_wrong_b_length_raises():
    port, _ = _solvers("apache_small")
    ex = port.executor
    lx = ex.factorize(port.ap.data)
    with pytest.raises(ValueError, match="expected a vector"):
        ex.solve_loop(lx, np.ones(port.a.n + 1), 2)


def test_fused_executor_runs_the_programs():
    name = "apache_small"
    port, _ = _solvers(name)
    exf = SupernodalExecutor(port.plan, "float32", "cpu",
                             fused_finalize=True)
    assert any(exf._fused_cls)
    a = port.ap.data
    eager = exf._factorize_eager(a)
    for pools in (exf.factorize(a), exf.factorize_segmented(a, 2),
                  exf.factorize_loop(a, 2)):
        assert _bit_equal(pools, eager)
    _assert_close(name, eager, [p.numpy() for p in
                                port.executor.factorize(a)])
    assert {"factorize", "init", "segments[0:2]"} <= set(exf.programs)


def test_program_on_the_cpu_calls_its_closure():
    calls = []
    cpu = torch.device("cpu")
    prog = graphs.Program("p", lambda: calls.append(1), cpu,
                          graphs.graph_pool(cpu))
    prog.run()
    prog.run()
    assert len(calls) == 2
    assert prog.capture_s is None and prog.nodes is None
    assert prog.launches == {k: 0 for k in kernels.launch_counts()}
