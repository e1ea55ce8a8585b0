"""The port's multi-device tier against the JAX package, on the CPU:

* the copied ``symbolic/{partition,dplan}.py``: the same owners, costs and
  boundary statistics, and every array of the distributed plan equal to
  the JAX plan's, each package from its own inspector;
* ``DistExecutor`` in gloo rank processes (``parallel/comm.launch``)
  against the JAX ``DistExecutor`` on the conftest's virtual CPU devices:
  the same plan and inputs, factor values within 1e-5 and the three
  solves within 1e-4 in f32, 1e-10 in f64; the grouped factorize equal to
  the monolithic one;
* the launcher: a rank that raises fails the parent, within its time
  limit; every rank's tensors sit on the device asked for; the layouts
  the backends refuse.

The ranks of one G start once: ``_port_runs`` runs every job of that G in
one launch (``runs.run_jobs``).  Each JAX side compiles once per
configuration.
"""
import functools
import time

import numpy as np
import pytest
import scipy.sparse as sp

import jax

# as in every test file that shares a worker with JAX f64 tests
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import torch
from jax.sharding import Mesh

from parsy_bench_tpu.config import SolverConfig
from parsy_bench_tpu.core import generate
from parsy_bench_tpu.models import CholeskySolver as JaxCholeskySolver
from parsy_bench_tpu.parallel.dist import DistExecutor as JaxDistExecutor
from parsy_bench_tpu.symbolic import dplan as jax_dplan
from parsy_bench_tpu.symbolic import partition as jax_partition
from parsy_bench_tpu_torch import CholeskySolver
from parsy_bench_tpu_torch import SolverConfig as PortConfig
from parsy_bench_tpu_torch.core import generate as port_generate
from parsy_bench_tpu_torch.parallel import DistExecutor, comm, runs
from parsy_bench_tpu_torch.symbolic import dplan, partition
from parsy_bench_tpu_torch.symbolic.supernodes import (
    supernodal_rows_from_etree)
from test_torch_native import reload_native_libs
from test_torch_supernodal import _assert_same

# a test process that lost a native library's first-build race
# loads it now, so both packages' inspectors run native
reload_native_libs()
torch.set_num_threads(1)

#: seconds a launch may take here (rank start-up is a few seconds)
LAUNCH_S = 300


@functools.lru_cache(maxsize=None)
def _solvers(name, dtype="float32"):
    """(port solver, JAX solver) analyzed from each package's own
    generator, config and inspector (supernodal tier, the default
    ordering)."""
    port = CholeskySolver(port_generate.SUITE[name](),
                          PortConfig(tier="supernodal", dtype=dtype),
                          device="cpu")
    ref = JaxCholeskySolver(generate.SUITE[name](),
                            SolverConfig(tier="supernodal", dtype=dtype))
    assert np.array_equal(port.perm, ref.perm)
    return port, ref


@functools.lru_cache(maxsize=None)
def _plans(name, G):
    port, ref = _solvers(name)
    return (dplan.build_dist_plan(port.ap, port.parent, port.cc, G,
                                  port.config),
            jax_dplan.build_dist_plan(ref.ap, ref.parent, ref.cc, G,
                                      ref.config))


@pytest.mark.parametrize("G", [2, 4, 8])
def test_partition_copy_matches_jax(G):
    """supernode_costs, partition_supernodes and boundary_fraction of the
    copy give the JAX module's results on the same inputs."""
    port, _ = _solvers("ecology_small")
    part = port.plan.layout.part
    cost = partition.supernode_costs(part.sptr, port.cc)
    assert np.array_equal(cost, jax_partition.supernode_costs(part.sptr,
                                                               port.cc))
    owner = partition.partition_supernodes(part.sparent, cost, G)
    assert np.array_equal(owner, jax_partition.partition_supernodes(
        part.sparent, cost, G))
    assert len(np.unique(owner)) == G
    rptr, rows = supernodal_rows_from_etree(port.ap, port.parent, part)
    args = (rptr, rows, part.sptr, part.col2sup, owner)
    assert (partition.boundary_fraction(*args)
            == jax_partition.boundary_fraction(*args))


@pytest.mark.parametrize("name,G", [("bcsstk14ish", 2), ("bcsstk14ish", 4),
                                    ("bcsstk14ish", 8),
                                    ("ecology_small", 4)])
def test_dist_plan_matches_jax(name, G):
    """Every field of the distributed plan, down to every table array of
    every segment and bucket and ``layout_meta``, equals the JAX plan's."""
    mine, ref = _plans(name, G)
    assert type(mine).__module__ == "parsy_bench_tpu_torch.symbolic.dplan"
    _assert_same(mine, ref, "plan")
    assert mine.pool_elems_per_device() == ref.pool_elems_per_device()
    assert mine.psum_bytes_per_step() == ref.psum_bytes_per_step()


def test_boundary_volume_smaller_than_window():
    """The port's plan keeps the architecture claim of
    tests/test_dist.py: the ragged boundary rows, summed over every
    (class, step), stay well below a full per-level window psum."""
    mine, _ = _plans("ecology_small", 4)
    boundary = window = 0
    for seg in mine.segments:
        for ci, c in enumerate(mine.classes):
            boundary += seg.nsteps * seg.btot[ci] * c
            window += seg.nsteps * seg.wslice[ci] * c
    assert window > 0
    assert boundary < 0.3 * window, (boundary, window)


def test_solve_boundary_volume_below_r4_design():
    """Both distributed solves of the port's plan move boundary slots,
    well below full (n+1)-vector psums per step."""
    mine, _ = _plans("bcsstk14ish", 4)
    m = mine.psum_bytes_per_step()
    assert m["solve_lower_bytes"] < 0.5 * m["solve_r4_design_bytes"]
    assert m["solve_upper_bytes"] < 0.5 * m["solve_r4_design_bytes"]


def _rhs(solver, lvals):
    """b = L*1, L^T*1 and A*1 (x = 1 for each solve), float64."""
    n = solver.a.n
    lpat = solver.lpat
    lm = sp.csc_matrix((np.asarray(lvals, dtype=np.float64), lpat.indices,
                        lpat.indptr), shape=(n, n))
    full = solver.ap.symmetrize_from_lower().to_scipy()
    return dict(solve_lower=lm @ np.ones(n), solve_upper=lm.T @ np.ones(n),
                solve_spd=full @ np.ones(n))


@functools.lru_cache(maxsize=None)
def _jax_runs(G, dtype):
    """The JAX DistExecutor on bcsstk14ish: factor values and the three
    solves (solve_spd as solve_upper of solve_lower, on the two compiled
    programs)."""
    _, ref = _solvers("bcsstk14ish", dtype)
    plan = jax_dplan.build_dist_plan(ref.ap, ref.parent, ref.cc, G,
                                     ref.config)
    ex = JaxDistExecutor(plan, Mesh(np.array(jax.devices()[:G]), ("p",)),
                         dtype=jnp.dtype(dtype))
    pools = ex.factorize(ref.ap.data.astype(dtype))
    vals = np.asarray(ex.factor_values(pools, ref.lpat))
    rhs = _rhs(ref, vals)
    out = dict(values=vals, rhs=rhs)
    for name in ("solve_lower", "solve_upper"):
        out[name] = np.asarray(getattr(ex, name)(pools, rhs[name]))
    out["solve_spd"] = np.asarray(ex.solve_upper(
        pools, ex.solve_lower(pools, rhs["solve_spd"])))
    return out


#: G -> the port's dist jobs: (dtype, grouped factorize's group or None)
PORT_JOBS = {2: (("float32", None), ("float64", None)),
             4: (("float32", 3),)}


@functools.lru_cache(maxsize=None)
def _port_runs(G):
    """Every dist job of ``PORT_JOBS[G]`` in one launch of G gloo ranks on
    the CPU, on the port's own plan, with the JAX side's right-hand
    sides: {dtype: [record of each rank]}."""
    jobs = []
    for dtype, grouped in PORT_JOBS[G]:
        port, _ = _solvers("bcsstk14ish", dtype)
        plan = dplan.build_dist_plan(port.ap, port.parent, port.cc, G,
                                     port.config)
        jobs.append(("dist", dict(
            plan=plan, a_data=port.ap.data, dtype=dtype, lpat=port.lpat,
            solves=_jax_runs(G, dtype)["rhs"], segmented=grouped)))
    out = comm.launch(runs.run_jobs, G, "gloo", "cpu", (jobs,),
                      timeout=LAUNCH_S)
    return {dtype: [ranks[k] for ranks in out]
            for k, (dtype, _) in enumerate(PORT_JOBS[G])}


@pytest.mark.parametrize("G,dtype", [(2, "float32"), (4, "float32"),
                                     (2, "float64")])
def test_dist_executor_matches_jax(G, dtype):
    """Factor values within 1e-5 (f32) or 1e-10 (f64) of the JAX
    DistExecutor's and the three solves within 1e-4 (1e-10), x = 1 within
    the reference's 1e-3; every rank holds the same values and x."""
    recs = _port_runs(G)[dtype]
    ref = _jax_runs(G, dtype)
    r0 = recs[0]
    bars = (1e-5, 1e-4) if dtype == "float32" else (1e-10, 1e-10)
    assert np.max(np.abs(r0["values"] - ref["values"])) < bars[0]
    for name in ("solve_lower", "solve_upper", "solve_spd"):
        assert np.max(np.abs(r0[name] - ref[name])) < bars[1], name
        assert np.max(np.abs(r0[name] - 1.0)) < 1e-3, name
    assert [r["rank"] for r in recs] == list(range(G))
    assert all(r["digest"] == r0["digest"] for r in recs)
    # one psum per (class, level step) of the factorize, the same on
    # every rank; no kernel launches on the CPU
    plan = _plans("bcsstk14ish", G)[0]
    ncls_steps = sum(seg.nsteps * len(seg.wslice) for seg in plan.segments)
    assert all(r["psum_calls"] == ncls_steps for r in recs)
    # their payload is what psum_bytes_per_step models, at 4 bytes an
    # entry, before its ring factor
    ring = 2.0 * (G - 1) / G
    itemsize = np.dtype(dtype).itemsize
    assert all(r["psum_bytes"] * ring * 4 / itemsize
               == plan.psum_bytes_per_step()["factorize_bytes"]
               for r in recs)
    assert all(r["k1_launches"] == 0 for r in recs)
    assert all(r["chol_calls_per_factorize"] > 0 for r in recs)


def test_ranks_check_k1_at_their_batch_shapes():
    """Each rank recorded the (P, c) of every chol batch of its first
    factorize: per class and level step, the lanes of all the class's
    finalize buckets on that rank; and held K1 against its plain version
    at each (here the plain version on both sides: error 0)."""
    plan = _plans("bcsstk14ish", 2)[0]
    want = {(sum(b.P for b in seg.fin if b.ccls == ci), int(c))
            for seg in plan.segments
            for ci, c in enumerate(plan.classes)
            if any(b.ccls == ci for b in seg.fin)}
    for r in _port_runs(2)["float32"]:
        assert {(P, c) for P, c, _, _ in r["k1_checks"]} == want
        assert all(el == 0.0 and ei == 0.0
                   for _, _, el, ei in r["k1_checks"])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_rank_k1_check_catches_a_wrong_result(monkeypatch, dtype):
    """``runs._check_k1`` raises when ``chol_inverse`` is off its plain
    version by more than the bar, in L or in Linv."""
    from parsy_bench_tpu_torch.ops import dense, supernodal
    cpu, dt = torch.device("cpu"), getattr(torch, dtype)
    shapes = {(9, 32), (2, 128)}
    assert len(runs._check_k1(cpu, dt, shapes, 0)) == 2
    tol = 1e-5 if dtype == "float32" else 1e-10
    for k in (0, 1):
        def off(D, k=k):
            out = list(dense.cholesky_inverse(D))
            out[k] = out[k] + 2 * tol * D.shape[1]
            return tuple(out)
        monkeypatch.setattr(supernodal, "chol_inverse", off)
        with pytest.raises(AssertionError, match="plain version"):
            runs._check_k1(cpu, dt, shapes, 0)


def test_dist_grouped_equals_monolithic():
    """factorize_segmented(group=3) gives factorize's pools on every
    rank."""
    recs = _port_runs(4)["float32"]
    assert all(r["segmented_max_diff"] == 0.0 for r in recs)
    assert all(r["pool_scale"] > 0 for r in recs)


def test_ranks_import_no_jax_and_sit_on_their_device():
    """Every rank ran without jax or the JAX package, and its executor's
    tensors sit on the device the launch asked for."""
    recs = _port_runs(2)["float32"]
    assert all(r["jax_free"] for r in recs)
    assert all(r["device"] == "cpu" and r["pool_devices"] == ["cpu"]
               and r["backend"] == "gloo" for r in recs)
    mine, _ = _plans("bcsstk14ish", 2)
    _, ref = _solvers("bcsstk14ish")
    assert recs[0]["pool_bytes"] < ref.plan.pool_elems() * 4
    assert mine.pool_elems_per_device() < ref.plan.pool_elems()


def test_failing_rank_fails_the_parent():
    """A rank that raises makes ``launch`` raise, within its time limit,
    while the other rank waits in a psum for it."""
    t0 = time.monotonic()
    with pytest.raises(comm.RankError, match="rank 1 of 2 raised"):
        comm.launch(runs.fail_on, 2, "gloo", "cpu", (1,), timeout=120)
    assert time.monotonic() - t0 < 120


def test_layouts_the_backends_refuse():
    with pytest.raises(ValueError, match="one CUDA device per rank"):
        comm.launch(runs.fail_on, 2, "nccl", "cpu", (1,))
    with pytest.raises(ValueError, match="one CUDA device per rank"):
        comm.launch(runs.fail_on, 2, "nccl", "cuda:0", (1,))
    with pytest.raises(ValueError, match="backend"):
        comm.launch(runs.fail_on, 2, "mpi", "cpu", (1,))
    with pytest.raises(ValueError, match="devices for"):
        comm.launch(runs.fail_on, 2, "gloo", ["cpu"], (1,))


def test_executors_ask_for_the_card(monkeypatch):
    """Without ``device`` the executors ask for the card and raise where
    there is none; a device that is not the group's is refused."""
    from parsy_bench_tpu_torch.parallel import (ShardedSimplicialExecutor,
                                                ShardedSupernodalExecutor)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mine, _ = _plans("bcsstk14ish", 2)
    group = comm.Group(0, 2, torch.device("cpu"), "gloo")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DistExecutor(mine, group)
    a = port_generate.SUITE["tiny"]()
    sharded = CholeskySolver(a, PortConfig(tier="supernodal",
                                           num_partitions=2), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ShardedSupernodalExecutor(sharded.plan, group)
    simp = CholeskySolver(a, PortConfig(tier="simplicial"), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ShardedSimplicialExecutor(simp.plan, group)
    with pytest.raises(ValueError, match="group has 2"):
        DistExecutor(_plans("bcsstk14ish", 4)[0], group, device="cpu")
