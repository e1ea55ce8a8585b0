"""The port's attribution scripts (``parsy_bench_tpu_torch/scripts/``) on
the CPU against the JAX package, at ``laplace_3d(8)`` ND (n = 512, 4
segments) in f64 and f32.

* every floor_r5 mode applied to one segment, from the same input pools,
  equals its JAX counterpart (``full``: JAX ``_step``; ``upd_only``:
  ``_apply_updates`` + ``_rows_write``; ``fin_only``: ``_finalize``;
  ``gather_only``: a numpy sum of the tiled (R, c) pool rows);
  ``einsum_only`` leaves the pools as they were and calls
  ``update_block`` once per bucket-step;
* fin_ablate's ``full`` and ``xlachol`` equal JAX ``_finalize``;
  ``cholonly`` leaves the windows as they were; its ablation body with
  nothing taken out is bit-equal to the executor's ``_finalize``;
* ``attribution.scope_ms`` counts an operation under its innermost scope
  only and reports nested scopes; the executor's scopes nest nowhere; the
  scripts refuse a solver that finalizes fused buckets;
* solve_floor's truncated solve at k = 1, 2 and nseg equals the JAX
  solve with ``plan.solve_nseg = k``;
* each ``main()`` prints the JAX script's keys (read from its text with
  ``ast``), and K1's launches per mode follow the plan;
* each module run without CUDA exits non-zero without a line.

Input pools are the port's factor through the segments before the one
under test, from A values perturbed from a numpy seed (diagonal raised,
off-diagonal shrunk: still SPD).  Bars: 1e-10 of the pool scale in f64,
1e-4 in f32.  One JAX compile per (dtype, segment, mode).
"""
import ast
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import torch

from parsy_bench_tpu.config import SolverConfig as JaxConfig
from parsy_bench_tpu.core import generate as jax_generate
from parsy_bench_tpu.models import CholeskySolver as JaxSolver
from parsy_bench_tpu_torch import CholeskySolver, SolverConfig
from parsy_bench_tpu_torch.core import generate
from parsy_bench_tpu_torch.ops import dense, kernels, supernodal
from parsy_bench_tpu_torch.scripts import (attribution, fin_ablate, floor_r5,
                                           solve_floor)
from test_torch_native import reload_native_libs

reload_native_libs()
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_GRID = 8
#: dtype -> the segment its mode cases run on (segment 1: two level
#: steps, one update bucket; segment 2: four update buckets, two classes)
_SEGMENT = {"float64": 1, "float32": 2}
_BAR = {"float64": 1e-10, "float32": 1e-4}


@functools.lru_cache(maxsize=None)
def _solvers(dtype):
    """(port solver, JAX solver, A values from the seed) on the CPU."""
    kw = dict(ordering="nd", dtype=dtype, tier="supernodal")
    port = CholeskySolver(generate.laplace_3d(_GRID), SolverConfig(**kw),
                          device="cpu")
    ref = JaxSolver(jax_generate.laplace_3d(_GRID), JaxConfig(**kw))
    ap = port.ap
    np.testing.assert_array_equal(ap.data, ref.ap.data)
    rng = np.random.default_rng(13)
    col = np.repeat(np.arange(ap.n), np.diff(ap.indptr))
    diag = ap.indices == col
    vals = ap.data.astype(np.float64).copy()
    vals[diag] += rng.uniform(0.0, 1.0, int(diag.sum()))
    vals[~diag] *= rng.uniform(0.5, 1.0, int((~diag).sum()))
    return port, ref, vals


@functools.lru_cache(maxsize=None)
def _input(dtype, i):
    """Numpy pools before segment i: the port's steps of segments < i."""
    port, _, vals = _solvers(dtype)
    ex = port.executor
    pools = ex.init_pools(vals)
    for seg, tabs in zip(ex.plan.segments[:i], ex._segs[:i]):
        for t in range(seg.nsteps):
            ex._step(pools, seg, tabs, t)
    return tuple(p.numpy().copy() for p in pools)


def _port_mode(dtype, i, mode):
    ex = _solvers(dtype)[0].executor
    pools = tuple(torch.from_numpy(s.copy()) for s in _input(dtype, i))
    floor_r5.segment_body(ex, i, mode, pools)()
    return [p.numpy() for p in pools]


def _jax_steps(jex, i, mode):
    """JAX's counterpart of a floor_r5 mode, as one step of segment i."""
    def full(ps, seg, u, f, rlo, g):
        return jex._step(ps, seg, u, f, rlo, None, g)

    def partial(ps, seg, u, f, rlo, g):
        wins = [jex._rows_view(ps[ci], ci, rlo[ci], seg.wslice[ci])
                for ci in range(jex.ncls)]
        if mode == "upd_only":
            wins = jex._apply_updates(ps, wins, seg, u, None, g)
        else:
            wins = jex._finalize(wins, seg, f)
        return [jex._rows_write(ps[ci], ci, rlo[ci], wins[ci])
                for ci in range(jex.ncls)]
    return full if mode == "full" else partial


@functools.lru_cache(maxsize=None)
def _jax_mode(dtype, i, mode):
    """Segment i's JAX scan in ``mode`` from ``_input``, driven through
    ``_unpack(_flat_rep, _flat_upd)[i]`` and ``_unpack_gsc(_flat_rep)[i]``
    as ``profile_segments`` drives it."""
    jex = _solvers(dtype)[1].executor
    seg = jex.plan.segments[i]
    step_fn = _jax_steps(jex, i, mode)

    def run(pools, fr, fu):
        xs4 = jex._unpack(fr, fu)[i] + (jex._unpack_gsc(fr)[i],)

        def step(ps, xs):
            u, f, rlo, g = xs
            return step_fn(list(ps), seg, u, f, rlo, g), None
        return jax.lax.scan(step, list(pools), xs4)[0]
    out = jax.jit(run)([jnp.asarray(s) for s in _input(dtype, i)],
                       jex._flat_rep, jex._flat_upd)
    return [np.asarray(p) for p in out]


def _assert_close(dtype, got, want):
    scale = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=_BAR[dtype] * scale)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("mode", ["full", "upd_only", "fin_only"])
def test_floor_r5_mode_matches_jax(dtype, mode):
    i = _SEGMENT[dtype]
    _assert_close(dtype, _port_mode(dtype, i, mode), _jax_mode(dtype, i, mode))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_floor_r5_einsum_only_runs_every_product_and_lands_nothing(
        dtype, monkeypatch):
    i = _SEGMENT[dtype]
    seg = _solvers(dtype)[0].plan.segments[i]
    calls = []
    block = supernodal.update_block

    def counted(*args):
        calls.append(args[4])
        return block(*args)
    monkeypatch.setattr(supernodal, "update_block", counted)
    got = _port_mode(dtype, i, "einsum_only")
    assert len(calls) == seg.nsteps * len(seg.upd) > 0
    for g, s in zip(got, _input(dtype, i)):
        np.testing.assert_array_equal(g, s)


def _numpy_gathers(ex, dtype, i):
    """gather_only in numpy from the plan's own tables: per step and
    class, the ladder sums over the class's pool rows tiled to 1 + the
    contribution rows, taken into the window and subtracted."""
    seg = ex.plan.segments[i]
    pools = [s.copy() for s in _input(dtype, i)]
    rlo = np.asarray(seg.rlo).reshape(ex.ncls, seg.nsteps)
    for t in range(seg.nsteps):
        for ci, c in enumerate(ex.classes):
            ent = seg.gsc[ci]
            if ent is None:
                continue
            ntot = 1 + sum(b.arow.shape[0] * b.arow.shape[2] * b.Mc
                           for b in seg.upd if b.ccls == ci)
            rows = pools[ci].reshape(-1, c)
            call = rows[np.arange(ntot) % rows.shape[0]]
            parts = [np.zeros((1, c))] + [call[g[t]].sum(axis=1)
                                          for g in ent["gidx"]]
            w = seg.wslice[ci]
            rows[rlo[ci, t]:rlo[ci, t] + w] -= np.concatenate(
                parts)[ent["pidx"][t]]
    return pools


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_floor_r5_gather_only_is_the_ladder_over_tiled_pool_rows(dtype):
    i = _SEGMENT[dtype]
    ex = _solvers(dtype)[0].executor
    got = _port_mode(dtype, i, "gather_only")
    _assert_close(dtype, got, _numpy_gathers(ex, dtype, i))
    assert any(not np.array_equal(g, s)
               for g, s in zip(got, _input(dtype, i)))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fin_ablate_body_with_nothing_taken_out_is_the_executor_finalize(
        dtype):
    ex = _solvers(dtype)[0].executor
    for i, (seg, tabs) in enumerate(zip(ex.plan.segments, ex._segs)):
        want = tuple(torch.from_numpy(s.copy()) for s in _input(dtype, i))
        got = tuple(torch.from_numpy(s.copy()) for s in _input(dtype, i))
        for t in range(seg.nsteps):
            ex._finalize(ex._windows(want, seg, tabs, t), seg, tabs, t)
            fin_ablate._swapped()(ex, ex._windows(got, seg, tabs, t), seg,
                                  tabs, t)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), i


def test_scope_ms_counts_an_operation_under_its_innermost_scope_once():
    x = torch.ones(64)
    scope = torch.profiler.record_function

    def fn():
        with scope("outer"):
            x.add(1)
            with scope("inner"):
                x.mul(2)
    out = attribution.scope_ms(fn, ("outer", "inner"), torch.device("cpu"))
    assert out["nested"] == 1 and out["ops"] == 2
    assert out["scopes"]["outer"] > 0 and out["scopes"]["inner"] > 0
    assert out["scopes"]["outer"] + out["scopes"]["inner"] == \
        pytest.approx(out["busy"])


def test_scripts_refuse_a_solver_that_finalizes_fused_buckets():
    port = _solvers("float32")[0]
    fused = supernodal.SupernodalExecutor(port.plan, "float32", "cpu",
                                          fused_finalize=True)
    assert fused.fused_calls_per_factorize > 0
    old = port.executor
    port.executor = fused
    try:
        with pytest.raises(ValueError, match="fused"):
            attribution.own_executor(port, "cpu")
    finally:
        port.executor = old


def _fin_ablate_mode(dtype, i, mode):
    """fin_ablate's program body on the static pools of the solver's
    executor, loaded with ``_input``."""
    ex = _solvers(dtype)[0].executor
    for p, s in zip(ex._pools, _input(dtype, i)):
        p.copy_(torch.from_numpy(s))
    ex._held.pop("pools", None)
    fin_ablate.segment_body(ex, i, mode)()
    return [p.numpy().copy() for p in ex._pools]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("mode", ["full", "xlachol"])
def test_fin_ablate_matches_jax_finalize(dtype, mode):
    i = _SEGMENT[dtype]
    _assert_close(dtype, _fin_ablate_mode(dtype, i, mode),
                  _jax_mode(dtype, i, "fin_only"))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fin_ablate_cholonly_leaves_the_windows(dtype):
    i = _SEGMENT[dtype]
    for g, s in zip(_fin_ablate_mode(dtype, i, "cholonly"),
                    _input(dtype, i)):
        np.testing.assert_array_equal(g, s)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fin_ablate_noy_is_the_diff_with_blk_for_y(dtype, monkeypatch):
    """noy's tail is ``dense.finalize_diff`` with its one product,
    Y = blk Linv^T, replaced by blk."""
    i = _SEGMENT[dtype]
    ex = _solvers(dtype)[0].executor
    seg, tabs = ex.plan.segments[i], ex._segs[i]
    pools = tuple(torch.from_numpy(s.copy()) for s in _input(dtype, i))
    b, ft = seg.fin[0], tabs.fin[0]
    blk = ex._panel_blk(pools, b, ft, tabs.rlo, 0)
    w, c = ft.w[0], b.c
    L, Linv = dense.cholesky_inverse(dense.masked_spd(blk[:, :c], w, c,
                                                      blk.dtype))
    got = fin_ablate._diff_noy(blk, w, int(ft.cnt[0]), L, Linv)
    monkeypatch.setattr(torch, "bmm", lambda x, y: x)
    want = dense.finalize_diff(blk, w, int(ft.cnt[0]), L, Linv)
    assert torch.equal(got, want)


@functools.lru_cache(maxsize=None)
def _factor(dtype):
    """(executor of its own, its factor, b from the seed)."""
    port, _, vals = _solvers(dtype)
    ex = attribution.own_executor(port, "cpu")
    lx = ex.factorize_segmented(vals, group=16)
    b = np.random.default_rng(5).standard_normal(port.a.n)
    return ex, lx, b


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("k", [1, 2, "nseg"])
def test_solve_floor_truncated_solve_matches_jax(dtype, k):
    ex, lx, b = _factor(dtype)
    nseg = len(ex.plan.segments)
    k = nseg if k == "nseg" else k
    with solve_floor.truncated(ex, k):
        x = ex.solve_lower(lx, b).numpy()
    assert ex._solve_nseg == nseg
    assert "solve_lower_fast" not in ex.programs
    jex = _solvers(dtype)[1].executor
    old = jex.plan.solve_nseg
    jex.plan.solve_nseg = k
    jex.__dict__.pop("_solve_loop_fn", None)
    try:
        xj = np.asarray(jex.solve_loop([jnp.asarray(p.numpy()) for p in lx],
                                       b, 1))
    finally:
        jex.plan.solve_nseg = old
        jex.__dict__.pop("_solve_loop_fn", None)
    scale = max(float(np.abs(xj).max()), 1.0)
    np.testing.assert_allclose(x, xj, rtol=0, atol=_BAR[dtype] * scale)


def test_solve_floor_refuses_a_prefix_past_the_tables():
    ex, _, _ = _factor("float32")
    with pytest.raises(ValueError, match="solve prefix 0"):
        with solve_floor.truncated(ex, 0):
            pass
    assert ex._solve_nseg == len(ex.plan.segments)


# ------------------------------------------------------------- the lines
def _jax_keys(name):
    """Keys the JAX script ``scripts/<name>.py`` prints: the dict literal
    it assigns to ``out`` (which its last ``json.dumps`` prints), the
    constant keys it sets on ``out``, and for ``out[mode]`` the constants
    of the ``for mode in [...]`` loop; with the nested dicts' keys."""
    with open(os.path.join(_REPO, "scripts", f"{name}.py")) as f:
        tree = ast.parse(f.read())
    dumps = sorted((n for n in ast.walk(tree) if isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr == "dumps"),
                   key=lambda n: (n.lineno, n.col_offset))
    assert isinstance(dumps[-1].args[0], ast.Name)
    assert dumps[-1].args[0].id == "out"
    loops = {n.target.id: n.iter for n in ast.walk(tree)
             if isinstance(n, ast.For) and isinstance(n.target, ast.Name)}
    names = {t.id: n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
             for t in n.targets if isinstance(t, ast.Name)}

    def consts(node):
        """The string constants a loop iterates: a list literal, either
        branch of a conditional, or the value of a name."""
        if isinstance(node, ast.Name):
            return consts(names[node.id])
        if isinstance(node, ast.IfExp):
            return consts(node.body) | consts(node.orelse)
        return {e.value for e in node.elts}
    keys, nested = set(), {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        for tgt in node.targets:
            if (isinstance(tgt, ast.Name) and tgt.id in ("out", "row")
                    and isinstance(node.value, ast.Dict)):
                for k, v in zip(node.value.keys, node.value.values):
                    nested.setdefault(tgt.id, set()).add(k.value)
                    if isinstance(v, ast.Dict):
                        nested[k.value] = {kk.value for kk in v.keys}
            if (isinstance(tgt, ast.Subscript)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id in ("out", "row")):
                s = tgt.slice
                vals = ({s.value} if isinstance(s, ast.Constant) else
                        consts(loops[s.id]))
                # floor_r5's update helper indexes a list named out
                nested.setdefault(tgt.value.id, set()).update(
                    v for v in vals if isinstance(v, str))
    keys = nested.pop("out")
    return keys, nested


def _main_line(module, argv, capsys):
    module.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


def _counted_k1(monkeypatch):
    """K1's plain version behind a stand-in that counts as the wrapper
    does, so that the programs' captures count it on the CPU."""
    def k1(D):
        kernels.cholesky_inverse_cuda.launches += 1
        return dense.cholesky_inverse(D)
    monkeypatch.setattr(supernodal, "chol_inverse", k1)


@pytest.mark.parametrize("all_modes", [False, True])
def test_floor_r5_main_prints_the_jax_keys(all_modes, capsys, monkeypatch):
    """With K1's counted stand-in: its launches per mode follow the
    plan."""
    _counted_k1(monkeypatch)
    keys, nested = _jax_keys("floor_r5")
    argv = ["--grid", str(_GRID), "--device", "cpu", "--reps", "2",
            "--iters", "1"] + (["--all-modes"] if all_modes else [])
    line = _main_line(floor_r5, argv, capsys)
    assert keys <= set(line)
    assert {"restore_s", "layers_ms", "card"} <= set(line)
    modes = list(floor_r5.ALL_MODES if all_modes else floor_r5.MODES)
    assert set(line["totals_s"]) == set(modes)
    marg = nested["marginals_s"]
    if not all_modes:
        marg = marg - {"gather_assembly_alone"}
    assert set(line["marginals_s"]) == marg
    assert line["segments_timed"] == list(range(line["nseg"]))
    for r in line["segments"]:
        assert set(r) == (nested["row"] - set(floor_r5.ALL_MODES)) | set(
            modes) | {"restore_s"}
    lay = line["layers_ms"]
    assert set(lay) == set(floor_r5.SCOPES) | {
        "busy", "other", "replayed_factorize_busy"}
    assert lay["busy"] > 0 and lay["replayed_factorize_busy"] > 0
    assert all(lay[s] > 0 for s in floor_r5.SCOPES)
    assert sum(lay[s] for s in floor_r5.SCOPES) + lay["other"] == \
        pytest.approx(lay["busy"])
    assert line["layers"]["nested"] == 0
    assert line["full_vs_eager"]["programs"]["bit_equal"]
    assert line["card"] == "cpu"
    total = _solvers("float32")[0].executor.chol_calls_per_factorize
    assert {m: r["capture"] for m, r in line["k1_launches"].items()} == {
        m: (total if m in floor_r5.K1_MODES else 0) for m in modes}
    assert all(r["plan"] == r["capture"]
               for r in line["k1_launches"].values())


def test_fin_ablate_main_prints_the_jax_keys(capsys):
    keys, _ = _jax_keys("fin_ablate")
    line = _main_line(fin_ablate, ["--grid", str(_GRID), "--device", "cpu",
                                   "--reps", "2", "--iters", "1"], capsys)
    assert keys <= set(line)
    assert set(fin_ablate.MODES) <= keys
    assert line["slices"] == 0.0 and line["segment"] == 0
    assert {"restore_s", "card"} <= set(line)


def test_solve_floor_main_prints_the_jax_keys(capsys):
    keys, _ = _jax_keys("solve_floor")
    line = _main_line(solve_floor, ["--grid", str(_GRID), "--device", "cpu",
                                    "--ks", "1,2", "--top", "256"], capsys)
    assert keys <= set(line)
    assert line["full_err"] < 1e-3 and set(line["prefix_s"]) == {"1", "2"}


def test_fin_ablate_k1_launches_per_mode_follow_the_plan(monkeypatch):
    _counted_k1(monkeypatch)
    port = _solvers("float32")[0]
    out = fin_ablate.run(port, "cpu", segment=1, reps=1, iters=1)
    want = attribution.k1_calls(port.executor, 1)
    assert {m: r["capture"] for m, r in out["k1_launches"].items()} == {
        m: (want if m in fin_ablate.K1_MODES else 0)
        for m in fin_ablate.VARIANTS}


def test_reps_on_own_output_reports_each_segment():
    out = attribution.reps_on_own_output(_solvers("float64")[0], "cpu",
                                         reps=2)
    assert out["segments"] == 4 and out["reps"] == 2
    assert out["finite"] == (not out["nonfinite_segments"])


@pytest.mark.parametrize("name", ["floor_r5", "fin_ablate", "solve_floor"])
def test_module_without_cuda_exits_nonzero_without_a_line(name):
    """As a user runs it, on a host without CUDA: the default device is
    the card, so there is no line and no fallback."""
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", f"parsy_bench_tpu_torch.scripts.{name}"],
        cwd=_REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert "CUDA" in out.stderr
