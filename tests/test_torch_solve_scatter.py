"""The leveled solves' scatters of real entries only
(``ops/supernodal.solve_scatter_lists``, ``_Scatter``), on the CPU at a
small 3D and a small 2D grid (ND, f32, supernodal):

* the lists: every position inside its block, no column or row is the pad
  slot n, n columns a direction and every row below a panel once;
  ``solve_scatter_counts`` says so, with nothing padded;
* the leveled ``solve_lower``, ``solve_upper`` and ``solve_spd`` bit for
  bit equal to an oracle that lands every padded lane on the slot n, as
  the solves did before the lists, and within the f32 bar of the JAX
  executor's solves (one JAX solver per configuration);
* the sharded solves (``parallel/sharded.py``, each rank's lanes filtered
  from the lists) at G = 2 equal to G = 1, on a plan where one rank owns
  only pad lanes of some bucket's step;
* ``tools/solve_scatter_count.py`` builds the plan ``CholeskySolver``
  builds and counts what the executor lands.
"""
import functools
import importlib.util
import os

import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import torch

from parsy_bench_tpu.config import SolverConfig
from parsy_bench_tpu.core import generate
from parsy_bench_tpu.models import CholeskySolver as JaxCholeskySolver
from parsy_bench_tpu_torch import CholeskySolver
from parsy_bench_tpu_torch import SolverConfig as PortConfig
from parsy_bench_tpu_torch.core import generate as port_generate
from parsy_bench_tpu_torch.ops.supernodal import solve_scatter_lists
from parsy_bench_tpu_torch.parallel import comm, runs
from test_torch_native import reload_native_libs

reload_native_libs()
torch.set_num_threads(1)

#: name -> matrix of a ``generate`` module
CASES = {"laplace3d10": lambda g: g.laplace_3d(10),
         "laplace2d24": lambda g: g.laplace_2d(24)}
CONFIG = dict(tier="supernodal", ordering="nd", dtype="float32")


@functools.lru_cache(maxsize=None)
def _port(case):
    return CholeskySolver(CASES[case](port_generate), PortConfig(**CONFIG),
                          device="cpu").factorize()


@functools.lru_cache(maxsize=None)
def _jax(case):
    """The JAX executor's three solves of ``_b``, factorized once."""
    ref = JaxCholeskySolver(CASES[case](generate),
                            SolverConfig(**CONFIG)).factorize()
    b = _b(ref.a.n)
    jex = ref.executor
    return {name: np.asarray(getattr(jex, name)(ref.lx, b))
            for name in ("solve_lower", "solve_upper", "solve_spd")}


def _b(n):
    return np.random.default_rng(3).standard_normal(n)


# ------------------------------------------------------------ the oracle
def _oracle_lower(ex, pools, b_vec):
    """The forward solve landing every padded lane on the slot n."""
    n = ex.plan.n
    zero1 = torch.zeros(1, dtype=ex.dtype)
    x = torch.zeros(n + 1, dtype=ex.dtype)
    bc = torch.cat([b_vec, zero1])
    for seg, tabs in zip(ex.plan.segments, ex._segs):
        for t in range(seg.nsteps):
            dx = torch.zeros_like(x)
            dbc = torch.zeros_like(x)
            for b, ft in zip(seg.fin, tabs.fin):
                blk = ex._panel_blk(pools, b, ft, tabs.rlo, t)
                w = ft.w[t]
                Linv = ex._inv_blk(blk, w, b.c)
                arc = ex._ar(b.c)
                cidx = torch.clamp(ft.cols0[t][:, None] + arc, max=n)
                colv = arc[None, :] < w[:, None]
                bvec = bc[cidx] * colv
                xs_ = torch.bmm(Linv, bvec[:, :, None])[:, :, 0] * colv
                dx.index_add_(0, torch.where(colv, cidx, n).reshape(-1),
                              xs_.masked_fill(~colv, 0).reshape(-1))
                y = torch.bmm(blk, xs_[:, :, None])[:, :, 0]
                below = ex._ar(b.H)[None, :] >= w[:, None]
                ridx = torch.where(below, ft.rows[t], n)
                dbc.index_add_(0, ridx.reshape(-1),
                               (-(y * below)).reshape(-1))
            x = x + dx
            x[n:].zero_()
            bc = bc + dbc
            bc[n:].zero_()
    return x[:n]


def _oracle_upper(ex, pools, b_vec):
    """The backward solve landing every padded lane on the slot n."""
    n = ex.plan.n
    zero1 = torch.zeros(1, dtype=ex.dtype)
    x = torch.zeros(n + 1, dtype=ex.dtype)
    bp = torch.cat([b_vec, zero1])
    for seg, tabs in zip(reversed(ex.plan.segments), reversed(ex._segs)):
        for t in reversed(range(seg.nsteps)):
            dx = torch.zeros_like(x)
            for b, ft in zip(seg.fin, tabs.fin):
                blk = ex._panel_blk(pools, b, ft, tabs.rlo, t)
                w = ft.w[t]
                Linv = ex._inv_blk(blk, w, b.c)
                below = ex._ar(b.H)[None, :] >= w[:, None]
                xr = x[ft.rows[t]] * below
                tt = torch.bmm(blk.transpose(1, 2), xr[:, :, None])[:, :, 0]
                arc = ex._ar(b.c)
                cidx = torch.clamp(ft.cols0[t][:, None] + arc, max=n)
                colv = arc[None, :] < w[:, None]
                rhs = (bp[cidx] - tt) * colv
                xs_ = torch.bmm(Linv.transpose(1, 2),
                                rhs[:, :, None])[:, :, 0] * colv
                dx.index_add_(0, torch.where(colv, cidx, n).reshape(-1),
                              xs_.masked_fill(~colv, 0).reshape(-1))
            x = x + dx
            x[n:].zero_()
    return x[:n]


ORACLE = {
    "solve_lower": _oracle_lower,
    "solve_upper": _oracle_upper,
    "solve_spd": lambda ex, p, b: _oracle_upper(ex, p,
                                                _oracle_lower(ex, p, b)),
}


# -------------------------------------------------------------- the lists
def _panel_rows_below(plan):
    """Rows below the panels, from the plan's heights: a panel of width w
    and height h has h - w rows below its diagonal block."""
    return sum(int(np.sum(b.h - b.w)) for seg in plan.segments
               for b in seg.fin)


@pytest.mark.parametrize("case", sorted(CASES))
def test_lists_hold_real_entries_only(case):
    s = _port(case)
    ex, n = s.executor, s.plan.n
    ncols = nrows = 0
    for seg, tabs in zip(s.plan.segments, ex._segs):
        for b, ft in zip(seg.fin, tabs.fin):
            sc = ft.sc
            for name in ("cpos", "rpos", "rrow"):
                assert getattr(sc, name).dtype == torch.int32
            assert sc.ccol.dtype == torch.int64
            assert sc.coff.shape == sc.roff.shape == (seg.nsteps + 1,)
            assert np.all(np.diff(sc.coff) >= 0)
            assert np.all(np.diff(sc.roff) >= 0)
            ccol, rrow = sc.ccol.numpy(), sc.rrow.numpy()
            assert np.all((ccol >= 0) & (ccol < n))
            assert np.all((rrow >= 0) & (rrow < n))
            assert np.all(sc.cpos.numpy() < b.P * b.c)
            assert np.all(sc.rpos.numpy() < b.P * b.H)
            # each step's run in the flat order of the block
            for t in range(seg.nsteps):
                run = sc.cpos.numpy()[sc.coff[t]:sc.coff[t + 1]]
                assert np.all(np.diff(run) > 0)
            ncols += int(sc.coff[-1])
            nrows += int(sc.roff[-1])
    # each column once a direction; each row below a panel once
    assert ncols == n
    below = _panel_rows_below(s.plan)
    assert nrows == below > 0
    assert ex.solve_scatter_counts == {"landed": 2 * n + below,
                                       "padded": 0}


def test_lists_of_one_rank_are_its_lanes():
    """Filtered to the lanes p % G == rank, the ranks' lists split the
    unfiltered ones."""
    s = _port("laplace3d10")
    n = s.plan.n
    for seg in s.plan.segments:
        for b in seg.fin:
            full = solve_scatter_lists(b.w, b.cols0, b.rows, b.c, n)
            parts = [solve_scatter_lists(b.w, b.cols0, b.rows, b.c, n, 2, r)
                     for r in range(2)]
            for k, width in ((0, b.c), (3, b.H)):
                got = np.concatenate([p[k] for p in parts])
                assert np.array_equal(np.sort(got), np.sort(full[k]))
                for r, p in enumerate(parts):
                    assert np.all((p[k] // width) % 2 == r)
            assert parts[0][2][-1] + parts[1][2][-1] == full[2][-1]


# -------------------------------------------------------------- the solves
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("name", sorted(ORACLE))
def test_solves_equal_the_padded_oracle_and_jax(case, name):
    s = _port(case)
    ex = s.executor
    b = _b(s.plan.n)
    # the leveled forward solve, also where the plan has the fast one
    x = ex._solve(name, s.lx, b)
    want = ORACLE[name](ex, s.lx, ex._vec(b))
    assert torch.equal(x, want)
    ref = _jax(case)[name]
    assert np.max(np.abs(x.numpy() - ref)) <= 1e-3 * max(1.0,
                                                          np.abs(ref).max())


# ------------------------------------------------------------ the sharded
def _one_rank_owns_only_pads(plan, G):
    """A bucket and step at which some rank's lanes are all pads while
    another rank's are not."""
    for seg in plan.segments:
        for b in seg.fin:
            for t in range(seg.nsteps):
                real = np.asarray(b.w[t]) > 0
                mine = [real[r::G].any() for r in range(G)]
                if any(mine) and not all(mine):
                    return True
    return False


def test_sharded_solves_at_two_ranks_equal_one():
    a = port_generate.laplace_3d(10)
    b = _b(a.n)
    out = {}
    for G in (1, 2):
        s = CholeskySolver(a, PortConfig(**CONFIG, update_delta="scatter",
                                         num_partitions=G), device="cpu")
        assert s.plan.nshards == G
        if G == 2:
            assert _one_rank_owns_only_pads(s.plan, G)
        job = ("sharded_supernodal", dict(
            plan=s.plan, a_data=s.ap.data, dtype="float32",
            solves=dict(solve_lower=b, solve_spd=b)))
        recs = [r[0] for r in comm.launch(runs.run_jobs, G, "gloo", "cpu",
                                          ([job],), timeout=300)]
        assert all(r["digest"] == recs[0]["digest"] for r in recs)
        out[G] = recs[0]
    for name in ("values", "solve_lower", "solve_spd"):
        x, y = out[2][name], out[1][name]
        assert np.max(np.abs(x - y)) <= 1e-5 * max(1.0, np.abs(y).max()), \
            name


def test_count_tool_reads_the_plan_as_the_executor():
    """``tools/solve_scatter_count.py`` analyses as ``CholeskySolver``
    does and counts what the executor lands."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "solve_scatter_count.py")
    spec = importlib.util.spec_from_file_location("solve_scatter_count",
                                                  path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    for case in sorted(CASES):
        s = _port(case)
        got = tool.counts(tool.plan_of(CASES[case](port_generate),
                                       PortConfig(**CONFIG)))
        assert got["landed"]["total"] == s.executor.solve_scatter_counts[
            "landed"]
        assert got["padded"] == 0
        cells = sum(seg.nsteps * b.P * (2 * b.c + b.H)
                    for seg in s.plan.segments for b in seg.fin)
        assert (got["landed"]["total"] + got["padded_all_lanes"]["dx"]
                + got["padded_all_lanes"]["dbc"]) == cells
