"""The port's update-stream-sharded executors and the single-device
executor on a partitioned plan, against the JAX package on the CPU:

* ``ShardedSupernodalExecutor`` in G = 2 gloo ranks on apache_small (AMD,
  as tests/test_sharded.py) against the JAX ``ShardedSupernodalExecutor``
  on the conftest's virtual CPU devices (factor values within 1e-5,
  ``solve_lower`` within 1e-4) and against the port's single-device
  executor;
* ``ShardedSimplicialExecutor`` at G = 2 and 4 on bcsstk14ish against the
  JAX ``ShardedSimplicialExecutor`` (1e-5) and the port's
  ``SimplicialExecutor``;
* the single-device ``SupernodalExecutor`` on a plan with
  ``num_partitions=4`` (its update tables carry a G = 4 axis, which the
  port folds into the lanes) against the JAX single-device executor on
  the same plan, in f64 (1e-10);
* ``ShardedSupernodalExecutor`` in one rank (a stand-in group, in this
  process) on a scatter-mode plan with ``num_partitions=1``, bit for bit
  against the single-device ``_factorize_eager`` on the same plan: at
  G = 1 the rank's step is the single-device step.

The ranks of one G start once (``runs.run_jobs``); each JAX side compiles
once per configuration.
"""
import functools

import numpy as np
import pytest

import jax

# as in every test file that shares a worker with JAX f64 tests
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import torch
from jax.sharding import Mesh

from parsy_bench_tpu.config import SolverConfig
from parsy_bench_tpu.core import generate
from parsy_bench_tpu.models import CholeskySolver as JaxCholeskySolver
from parsy_bench_tpu.parallel import (ShardedSimplicialExecutor as
                                      JaxShardedSimplicial)
from parsy_bench_tpu.parallel import (ShardedSupernodalExecutor as
                                      JaxShardedSupernodal)
from parsy_bench_tpu_torch import CholeskySolver
from parsy_bench_tpu_torch import SolverConfig as PortConfig
from parsy_bench_tpu_torch.core import generate as port_generate
from parsy_bench_tpu_torch.ops.supernodal import (SupernodalExecutor,
                                                  chol_groups)
from parsy_bench_tpu_torch.parallel import comm, runs
from parsy_bench_tpu_torch.parallel.sharded import ShardedSupernodalExecutor
from test_torch_native import reload_native_libs

# a test process that lost a native library's first-build race
# loads it now, so both packages' inspectors run native
reload_native_libs()
torch.set_num_threads(1)

#: seconds a launch may take here (rank start-up is a few seconds)
LAUNCH_S = 300

SUPERNODAL = dict(name="apache_small", tier="supernodal", ordering="amd",
                  dtype="float32")
SIMPLICIAL = dict(name="bcsstk14ish", tier="simplicial", dtype="float32")


def _mesh(G):
    return Mesh(np.array(jax.devices()[:G]), ("p",))


@functools.lru_cache(maxsize=None)
def _solvers(name, **kw):
    """(port solver, JAX solver) of the matrix ``name`` and the config
    ``kw``, each analyzed by its own package, the port's factorized on the
    CPU."""
    port = CholeskySolver(port_generate.SUITE[name](), PortConfig(**kw),
                          device="cpu").factorize()
    ref = JaxCholeskySolver(generate.SUITE[name](), SolverConfig(**kw))
    assert np.array_equal(port.perm, ref.perm)
    return port, ref


def _b(n):
    return np.random.default_rng(7).standard_normal(n)


@functools.lru_cache(maxsize=None)
def _port_runs(G):
    """The sharded jobs of one G in one launch of G gloo ranks on the CPU:
    {name: [record of each rank]}."""
    jobs = []
    if G == 2:
        port, _ = _solvers(**SUPERNODAL, num_partitions=2)
        b = _b(port.a.n)
        jobs.append(("sharded_supernodal", dict(
            plan=port.plan, a_data=port.ap.data, dtype="float32",
            solves=dict(solve_lower=b, solve_spd=b))))
    simp, _ = _solvers(**SIMPLICIAL)
    jobs.append(("sharded_simplicial", dict(
        plan=simp.plan, a_data=simp.ap.data, dtype="float32")))
    out = comm.launch(runs.run_jobs, G, "gloo", "cpu", (jobs,),
                      timeout=LAUNCH_S)
    return {name: [ranks[k] for ranks in out]
            for k, (name, _) in enumerate(jobs)}


def test_sharded_supernodal_matches_jax_and_single_device():
    port, ref = _solvers(**SUPERNODAL, num_partitions=2)
    b = _b(port.a.n)
    jex = JaxShardedSupernodal(ref.plan, _mesh(2), dtype=jnp.float32)
    jpools = jex.factorize(ref.ap.data)
    jvals = np.asarray(jex.factor_values(jpools))
    jlow = np.asarray(jex.solve_lower(jpools, b))
    recs = _port_runs(2)["sharded_supernodal"]
    r0 = recs[0]
    assert all(r["digest"] == r0["digest"] and r["jax_free"] for r in recs)
    assert np.max(np.abs(r0["values"] - jvals)) < 1e-5
    assert np.max(np.abs(r0["solve_lower"] - jlow)) < 1e-4
    # the port's single-device executor, on the unpartitioned plan
    single, _ = _solvers(**SUPERNODAL)
    sex = single.executor
    assert np.allclose(r0["values"], sex.factor_values(single.lx).numpy(),
                       atol=1e-4)
    assert np.allclose(r0["solve_lower"],
                       sex.solve_lower(single.lx, b).numpy(), atol=1e-4)
    assert np.allclose(r0["solve_spd"], sex.solve_spd(single.lx, b).numpy(),
                       atol=1e-3 * max(1.0, np.abs(r0["solve_spd"]).max()))
    # one psum per class delta and per finalized class, each level step
    assert all(r["psum_calls"] == r0["psum_calls"] > 0 for r in recs)
    assert all(r["k1_launches"] == 0 for r in recs)
    # the chol batches the ranks recorded (and checked K1 at) are the
    # finalize's chol groups, P / G lanes of each bucket per rank
    plan = port.plan
    classes = [int(c) for c in plan.layout.classes]
    groups = [[chol_groups(plan, seg, [k for k, b in enumerate(seg.fin)
                                       if b.ccls == ci], c, 2)
               for ci, c in enumerate(classes)]
              for seg in plan.segments]
    want = {(sum(seg.fin[k].P // 2 for k in grp), c)
            for seg, per in zip(plan.segments, groups)
            for c, grps in zip(classes, per) for grp in grps}
    assert all(r["chol_calls_per_factorize"]
               == sum(seg.nsteps * sum(map(len, per))
                      for seg, per in zip(plan.segments, groups))
               for r in recs)
    assert all({(P, c) for P, c, _, _ in r["k1_checks"]} == want
               for r in recs)


@pytest.mark.parametrize("G", [2, 4])
def test_sharded_simplicial_matches_jax_and_single_device(G):
    port, ref = _solvers(**SIMPLICIAL)
    jex = JaxShardedSimplicial(ref.plan, _mesh(G), dtype=jnp.float32)
    jlx = np.asarray(jex.factorize(ref.ap.data))
    recs = _port_runs(G)["sharded_simplicial"]
    r0 = recs[0]
    assert [r["rank"] for r in recs] == list(range(G))
    assert all(r["digest"] == r0["digest"] and r["jax_free"] for r in recs)
    assert np.max(np.abs(r0["values"] - jlx)) < 1e-5
    single = port.lx.numpy()
    assert np.max(np.abs(r0["values"] - single)) < 1e-5 * np.abs(
        single).max()
    # one psum per level
    assert all(r["psum_calls"] == r["levels"] == port.plan.nlev
               for r in recs)


def test_single_device_on_partitioned_plan_matches_jax():
    """The port folds the G axis of a partitioned plan's update tables
    into the lanes of one batch (``ops/supernodal._lanes_major``); the
    JAX executor loops over it.  The two agree in f64."""
    case = dict(name="bcsstk14ish", tier="supernodal", ordering="amd",
                dtype="float64")
    port, ref = _solvers(**case, num_partitions=4)
    assert port.plan.nshards == 4
    assert all(seg.gsc is None for seg in port.plan.segments)
    ref.factorize()
    jex, ex = ref.executor, port.executor
    assert np.max(np.abs(ex.factor_values(port.lx).numpy()
                         - np.asarray(jex.factor_values(ref.lx)))) < 1e-10
    b = _b(port.a.n)
    for name in ("solve_lower", "solve_upper"):
        x = getattr(ex, name)(port.lx, b).numpy()
        y = np.asarray(getattr(jex, name)(ref.lx, b))
        assert np.max(np.abs(x - y)) < 1e-10 * max(1.0, np.abs(y).max())
    # and against the port on the unpartitioned plan
    plain, _ = _solvers(**case)
    assert np.max(np.abs(ex.factor_values(port.lx).numpy()
                         - plain.executor.factor_values(plain.lx).numpy())
                  ) < 1e-10


class _OneRank:
    """Rank 0 of a group of 1 on the CPU: ``psum`` returns its input and
    counts its calls."""
    rank, size, device = 0, 1, torch.device("cpu")

    def __init__(self):
        self.calls = 0

    def psum(self, t):
        self.calls += 1
        return t


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sharded_rank_at_one_rank_is_the_single_device_factorize(dtype):
    port = CholeskySolver(
        port_generate.SUITE["apache_small"](),
        PortConfig(tier="supernodal", ordering="amd", dtype=dtype,
                   update_delta="scatter", num_partitions=1), device="cpu")
    plan = port.plan
    assert plan.nshards == 1
    assert all(seg.gsc is None for seg in plan.segments)
    group = _OneRank()
    got = ShardedSupernodalExecutor(plan, group, dtype, "cpu").factorize(
        port.ap.data)
    want = SupernodalExecutor(plan, dtype, "cpu")._factorize_eager(
        port.ap.data)
    assert len(got) == len(want)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    # one psum per class delta and per finalized class, each level step
    ncls = len(plan.layout.classes)
    assert group.calls == sum(
        seg.nsteps * (ncls + len({b.ccls for b in seg.fin}))
        for seg in plan.segments)
