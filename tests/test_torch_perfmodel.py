"""The port's performance model and its fit (``utils/perfmodel.py``,
``utils/calibrate.py``) against the JAX package's module on the same
plans (CPU):

* ``segment_features``, ``factorize_cost(plan, chip).summary()`` (with
  the JAX ``ChipModel``'s constants passed to both, so that only the code
  is compared) and ``comm_cost`` equal the JAX module's;
* ``calibrate.fit`` recovers known constants from segment times the
  model itself gives, and ``calibrate.collect`` builds one row per
  segment from ``profile_segments``.
"""
import dataclasses

import numpy as np
import pytest

import jax

# as in every test file that shares a worker with JAX f64 tests
jax.config.update("jax_enable_x64", True)

import torch

from parsy_bench_tpu.config import SolverConfig as JaxSolverConfig
from parsy_bench_tpu.core import generate
from parsy_bench_tpu.models import CholeskySolver as JaxCholeskySolver
from parsy_bench_tpu.utils import perfmodel as jperf
from parsy_bench_tpu_torch import CholeskySolver, SolverConfig
from parsy_bench_tpu_torch.utils import calibrate, perfmodel
from test_torch_native import reload_native_libs

# a test process that lost a native library's first-build race loads it
# now, so both packages' inspectors run native
reload_native_libs()

torch.set_num_threads(1)

#: name -> (matrix factory, config overrides)
PLANS = {
    "laplace3d8_nd": (lambda: generate.laplace_3d(8), dict(ordering="nd")),
    "bcsstk14ish_amd": (lambda: generate.SUITE["bcsstk14ish"](),
                        dict(ordering="amd")),
    "apache_small_nd_g2": (lambda: generate.SUITE["apache_small"](),
                           dict(ordering="nd", num_partitions=2,
                                update_delta="scatter")),
}


def _plans(name):
    a, kw = PLANS[name][0](), PLANS[name][1]
    port = CholeskySolver(a, SolverConfig(tier="supernodal", **kw),
                          device="cpu")
    ref = JaxCholeskySolver(a, JaxSolverConfig(tier="supernodal", **kw))
    return port, ref


@pytest.mark.parametrize("name", list(PLANS))
def test_model_matches_jax(name):
    port, ref = _plans(name)
    p, j = port.plan, ref.plan
    assert len(p.segments) == len(j.segments)
    for sp, sj in zip(p.segments, j.segments):
        assert (perfmodel.segment_features(sp, p.classes)
                == jperf.segment_features(sj, j.classes))
    consts = {f.name: getattr(jperf.ChipModel(), f.name)
              for f in dataclasses.fields(jperf.ChipModel)}
    chip = perfmodel.ChipModel(**consts)
    got = perfmodel.factorize_cost(p, chip)
    want = jperf.factorize_cost(j, jperf.ChipModel())
    assert got.summary() == want.summary()
    assert [k.model_s for k in got.kernels] == [k.model_s
                                                for k in want.kernels]
    assert perfmodel.comm_cost(p) == jperf.comm_cost(j)


def test_committed_chip_model_is_the_cards():
    """The port's defaults are a fit on the card, not the TPU's."""
    chip = perfmodel.ChipModel()
    assert "H100" in chip.name
    consts = [getattr(chip, f.name) for f in dataclasses.fields(chip)
              if f.name != "name"]
    assert all(c >= 0 and not np.isnan(c) for c in consts)
    assert chip != dataclasses.replace(jperf.ChipModel(), name=chip.name)


@pytest.mark.parametrize("mxu_flops", [3e13, float("inf")])
def test_fit_recovers_known_constants(mxu_flops):
    """Segment times from the model at known constants (every segment of
    three plans, each also at half its steps so that the columns are
    independent) are fitted back to those constants; a rate whose term
    takes no time (``mxu_flops`` = inf) is fitted to ``inf``, as in
    scripts/calibrate_model.py."""
    true = perfmodel.ChipModel(
        name="known", mxu_flops=mxu_flops, gather_rows=4e9,
        scatter_rows=2e9, stream_bytes=2e12, lane_s=2e-9, chain_op_s=3e-6,
        step_s=1e-5, upd_bucket_s=4e-6, fin_bucket_s=6e-6)
    rows = []
    for name in PLANS:
        plan = _plans(name)[0].plan
        for seg in plan.segments:
            f = perfmodel.segment_features(seg, plan.classes)
            for k in (1.0, 0.5):
                g = dict(f, steps=f["steps"] * k)
                g["median_s"] = perfmodel._segment_time(g, true)
                rows.append(g)
    fitted = calibrate.fit(rows)
    assert set(fitted) == set(calibrate.COLUMNS) | {"_fit_r2", "_residual_s"}
    assert fitted["_fit_r2"] > 1 - 1e-9
    assert fitted["_residual_s"] < 1e-9 * max(r["median_s"] for r in rows)
    for c in calibrate.COLUMNS:
        if np.isinf(getattr(true, c)):
            assert np.isinf(fitted[c]), c
        else:
            assert fitted[c] == pytest.approx(getattr(true, c), rel=1e-4), c


def test_collect_one_row_per_segment():
    s = CholeskySolver(generate.laplace_3d(6),
                       SolverConfig(tier="supernodal", ordering="nd"),
                       device="cpu")
    rows = calibrate.collect(s, iters=1, reps=1)
    assert len(rows) == len(s.plan.segments)
    for seg, r in zip(s.plan.segments, rows):
        f = perfmodel.segment_features(seg, s.plan.classes)
        assert {k: r[k] for k in f} == f and r["median_s"] > 0
