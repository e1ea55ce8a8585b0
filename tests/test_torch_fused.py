"""The port's fused finalize against the JAX package (CPU, small).

* the plain K2 (``ops/dense.finalize_fused``, the plain version of the CUDA
  kernel ``csrc/finalize_fused.cu``) against the TPU kernel
  ``finalize_fused_pallas`` in interpret mode (c <= 32; interpret mode is
  slow) and against the JAX XLA finalize chain (c = 128, f32 and f64).
  Bars: f32 1e-4 (the JAX test's own, tests/test_dense.py); f64 1e-10;
* the executor with ``fused_finalize=True`` against the JAX executor on
  the same plan.  The JAX fused branch runs only on a TPU backend, so the
  JAX side is its unfused chain, which computes the same thing.  Bars:
  f64 1e-10; f32 1e-3 of the largest pool entry.

The kernel itself needs the card: ``chip_smoke.py`` holds it against the
plain version there.
"""
import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import torch

from parsy_bench_tpu.config import SolverConfig
from parsy_bench_tpu.core import generate
from parsy_bench_tpu.models import CholeskySolver as JaxCholeskySolver
from parsy_bench_tpu.ops import dense as jdense
from parsy_bench_tpu.ops.pallas_kernels import finalize_fused_pallas
from parsy_bench_tpu_torch import CholeskySolver
from parsy_bench_tpu_torch.ops import dense, kernels, supernodal
from parsy_bench_tpu_torch.ops.convert import pools_to_numpy
from test_torch_native import reload_native_libs

# a test process that lost a native library's first-build race
# loads it now, so both packages' inspectors run native
reload_native_libs()

# one intra-op thread per test process: the suite runs several pytest
# workers at once, and torch's default pool (one thread per core) in each
# of them oversubscribes the cores many times over on these small ops
torch.set_num_threads(1)


def _bucket(rng, P, H, c, dtype):
    """A finalize bucket with an SPD top, as tests/test_dense.py makes
    it: (blk, w) numpy."""
    w = rng.integers(1, c + 1, P).astype(np.int32)
    blk = rng.standard_normal((P, H, c)).astype(dtype)
    A = rng.standard_normal((P, c, c)).astype(dtype)
    blk[:, :c, :] = np.einsum("pij,pkj->pik", A, A) + c * np.eye(
        c, dtype=dtype)
    return blk, w


def _jax_chain(blk, w, cnt):
    """The JAX XLA finalize chain (ops/supernodal._finalize inner loop,
    as written out in tests/test_dense.py)."""
    P, H, c = blk.shape
    blkj, wj = jnp.asarray(blk), jnp.asarray(w)
    D = jdense.masked_spd(blkj[:, :c, :], wj, c, blkj.dtype)
    L, Lib = jdense.cholesky_inverse(D)
    i_c = jax.lax.broadcasted_iota(jnp.int32, (1, c, c), 1)
    j_c = jax.lax.broadcasted_iota(jnp.int32, (1, c, c), 2)
    wv = wj[:, None, None]
    Ltop = jnp.where((i_c < wv) & (j_c < wv), L, 0)
    Ltop = Ltop + jnp.where((j_c > i_c) & (i_c < wv) & (j_c < wv),
                            jnp.swapaxes(Lib, 1, 2), 0)
    Y = jnp.einsum("phk,pck->phc", blkj, Lib,
                   precision=jax.lax.Precision.HIGHEST,
                   preferred_element_type=blkj.dtype)
    Y = jnp.where(jax.lax.broadcasted_iota(jnp.int32, (1, 1, c), 2) < wv,
                  Y, 0)
    top = jnp.where(i_c < wv, Ltop, Y[:, :c, :])
    out = jnp.concatenate([top, Y[:, c:, :]], axis=1)
    lane = jnp.arange(P)
    return np.asarray(jnp.where(lane[:, None, None] < cnt, out - blkj, 0))


@pytest.mark.parametrize("P,H,c,cnt", [(4, 32, 32, 3), (8, 64, 16, 8)])
def test_plain_k2_matches_pallas_interpret(P, H, c, cnt):
    rng = np.random.default_rng(7)
    blk, w = _bucket(rng, P, H, c, np.float32)
    diff = dense.finalize_fused(torch.as_tensor(blk), torch.as_tensor(w),
                                cnt).numpy()
    assert np.all(diff[cnt:] == 0)
    # tp = 2 runs the full-w path of the TPU kernel, tp = 8 the blocked one
    for tp in (2, 8):
        if P % tp:
            continue
        ref = np.asarray(finalize_fused_pallas(
            jnp.asarray(blk), jnp.asarray(w), jnp.int32(cnt), tp=tp,
            interpret=True))
        assert np.max(np.abs(diff - ref)) < 1e-4, tp


@pytest.mark.parametrize("dtype,bar", [("float32", 1e-4), ("float64", 1e-10)])
def test_plain_k2_matches_xla_chain_c128(dtype, bar):
    rng = np.random.default_rng(8)
    blk, w = _bucket(rng, 2, 256, 128, dtype)
    w[0] = 128
    diff = dense.finalize_fused(torch.as_tensor(blk), torch.as_tensor(w),
                                1).numpy()
    assert diff.dtype == np.dtype(dtype)
    ref = _jax_chain(blk, w, 1)
    assert np.max(np.abs(diff - ref)) < bar
    assert np.all(diff[1:] == 0)


def test_plain_k2_lanes_and_pivots():
    """A w = 0 lane below cnt clears its block, the top rows of a full
    lane carry L and Linv^T and the rows below it blk Linv^T, a negative
    pivot gives NaN, and lanes at or beyond cnt are exactly zero."""
    rng = np.random.default_rng(9)
    P, H, c, cnt = 5, 48, 16, 4
    blk, w = _bucket(rng, P, H, c, np.float64)
    w[1] = 0
    w[2:] = c
    blk[3, 5, 5] = -1e3
    blk[4] = np.nan
    diff = dense.finalize_fused(torch.as_tensor(blk), torch.as_tensor(w),
                                cnt).numpy()
    out = blk + diff
    assert np.array_equal(out[1], np.zeros((H, c)))
    L = np.linalg.cholesky(blk[2, :c, :])
    Linv = np.linalg.inv(L)
    assert np.allclose(np.tril(out[2, :c]), L, atol=1e-12)
    assert np.allclose(np.triu(out[2, :c], 1), np.triu(Linv.T, 1),
                       atol=1e-12)
    assert np.allclose(out[2, c:], blk[2, c:] @ Linv.T, atol=1e-12)
    assert np.isnan(diff[3]).any()
    assert np.array_equal(diff[4], np.zeros((H, c)))
    with pytest.raises(ValueError, match="height"):
        dense.finalize_fused(torch.zeros((1, 8, 16)),
                             torch.zeros(1, dtype=torch.int32), 1)


#: name -> (matrix factory, SolverConfig overrides), a subset of
#: tests/test_torch_supernodal.py's CASES
CASES = {
    "tiny_amd": (lambda: generate.SUITE["tiny"](), dict(ordering="amd")),
    "laplace3d8_nd": (lambda: generate.laplace_3d(8), dict(ordering="nd")),
    # fin_bucket_elems=4096 splits finalize buckets, so one class has
    # several buckets per step, applied in place one after another
    "laplace2d16_amd_split": (lambda: generate.laplace_2d(16),
                              dict(ordering="amd", fin_bucket_elems=4096)),
}


@pytest.mark.parametrize("case,dtype", [
    ("tiny_amd", "float64"), ("tiny_amd", "float32"),
    ("laplace3d8_nd", "float64"), ("laplace2d16_amd_split", "float64")])
def test_fused_executor_matches_jax(case, dtype):
    make, over = CASES[case]
    a = make()
    cfg = SolverConfig(tier="supernodal", dtype=dtype, **over)
    port = CholeskySolver(a, cfg, device="cpu", fused_finalize=True)
    ex = port.executor
    assert ex.fused_finalize and ex.fused_calls_per_factorize > 0
    port.factorize()
    ref = JaxCholeskySolver(a, cfg).factorize()
    jex = ref.executor
    jpools = [np.asarray(p) for p in ref.lx]
    scale = max(np.abs(p).max() for p in jpools)
    tol = 1e-10 if dtype == "float64" else 1e-3 * scale
    for p, q in zip(pools_to_numpy(port.lx), jpools):
        assert p.shape == q.shape and p.dtype == q.dtype
        assert np.max(np.abs(p - q)) <= tol
    assert np.max(np.abs(ex.factor_values(port.lx).numpy()
                         - np.asarray(jex.factor_values(ref.lx)))) <= tol
    b = np.random.default_rng(11).standard_normal(a.n)
    for fn, jfn in ((ex.solve_lower, jex.solve_lower),
                    (ex.solve_upper, jex.solve_upper),
                    (ex.solve_spd, jex.solve_spd)):
        r = np.asarray(jfn(ref.lx, b))
        bar = 1e-10 if dtype == "float64" else 1e-3 * max(1.0,
                                                          np.abs(r).max())
        assert np.max(np.abs(fn(port.lx, b).numpy() - r)) <= bar


def test_fused_call_counts():
    """Fused classes (c <= 64) leave the shared chol_inverse: one
    finalize_fused per bucket-step there, the same chol calls as unfused
    for the wider classes; the CPU run launches no kernel."""
    a = generate.laplace_3d(8)
    cfg = SolverConfig(tier="supernodal", dtype="float64", ordering="nd")
    base = CholeskySolver(a, cfg, device="cpu")
    plan = base.plan
    fused = supernodal.SupernodalExecutor(plan, "float64", "cpu",
                                          fused_finalize=True)
    narrow = sum(s.nsteps * sum(b.c <= 64 for b in s.fin)
                 for s in plan.segments)
    assert fused.fused_calls_per_factorize == narrow > 0
    assert base.executor.fused_calls_per_factorize == 0
    wide = sum(s.nsteps * sum(len(g) for ci, g in enumerate(t.fin_groups)
                              if base.executor.classes[ci] > 64)
               for s, t in zip(plan.segments, base.executor._segs))
    assert fused.chol_calls_per_factorize == wide
    assert base.executor.chol_calls_per_factorize > wide
    before = (kernels.finalize_fused_cuda.launches,
              kernels.cholesky_inverse_cuda.launches)
    pools = fused.factorize(base.ap.data)
    assert np.max(np.abs(pools_to_numpy(pools)[0]
                         - pools_to_numpy(
                             base.executor.factorize(base.ap.data))[0])) \
        <= 1e-12
    assert (kernels.finalize_fused_cuda.launches,
            kernels.cholesky_inverse_cuda.launches) == before


def test_finalize_fused_dispatch_cpu():
    """A CPU tensor goes to the plain version; the kernel wrapper refuses
    CPU tensors and counts nothing."""
    rng = np.random.default_rng(4)
    blk, w = _bucket(rng, 3, 32, 16, np.float64)
    blk_t, w_t = torch.as_tensor(blk), torch.as_tensor(w)
    before = kernels.finalize_fused_cuda.launches
    assert torch.equal(supernodal.finalize_fused(blk_t, w_t, 2),
                       dense.finalize_fused(blk_t, w_t, 2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.finalize_fused_cuda(blk_t, w_t, 2)
    assert kernels.finalize_fused_cuda.launches == before
