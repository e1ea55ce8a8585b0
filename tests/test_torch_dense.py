"""The port's plain Cholesky + inverse (parsy_bench_tpu_torch/ops/dense.py,
the plain version of the CUDA kernel) against the JAX package's
ops/dense.py and its Pallas kernel in interpret mode, on the same numpy
inputs.

Tolerances: f64 1e-10 (the reference's f64 bar); f32 1e-5*c on L and
1e-5 on Linv (the same algorithm in another framework sums in another
order, and L's error grows with the width).  Ill-conditioned f32 blocks
(cond 1e5) carry Linv entries of order 1e2 whose f32 error grows with
the condition number, so there Linv agrees to 1e-3 of its largest entry
and is held to the reference's own usability bars (tests/test_dense.py).
"""
import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import torch

from parsy_bench_tpu.ops import dense as jdense
from parsy_bench_tpu.ops.pallas_kernels import cholesky_inverse_pallas
from parsy_bench_tpu_torch.ops import dense

# one intra-op thread per test process: the suite runs several pytest
# workers at once, and torch's default pool (one thread per core) in each
# of them oversubscribes the cores many times over on these small ops
torch.set_num_threads(1)

_jchol = jax.jit(jdense.cholesky_inverse)


def _rand_spd(rng, p, c):
    A = rng.standard_normal((p, c, c))
    return A @ np.swapaxes(A, 1, 2) + c * np.eye(c)


def _ill_conditioned(rng, p, c):
    Q, _ = np.linalg.qr(rng.standard_normal((c, c)))
    D = (Q * np.logspace(0, -5, c)) @ Q.T          # cond 1e5
    return np.broadcast_to(0.5 * (D + D.T), (p, c, c))


def _masked(D, w, dtype):
    """(port masked D as torch, JAX masked D) from the same numpy input."""
    c = D.shape[1]
    tdt, jdt = {"float64": (torch.float64, jnp.float64),
                "float32": (torch.float32, jnp.float32)}[dtype]
    Dt = dense.masked_spd(torch.as_tensor(D.astype(dtype)),
                          torch.as_tensor(w), c, tdt)
    Dj = jdense.masked_spd(jnp.asarray(D.astype(dtype)), jnp.asarray(w), c,
                           jdt)
    return Dt, Dj


@pytest.mark.parametrize("c", [8, 16, 32, 128])
def test_cholesky_inverse_matches_jax_f64(c):
    """Full lanes, partly masked lanes and a w = 0 lane, in f64."""
    rng = np.random.default_rng(0)
    D = _rand_spd(rng, 5, c)
    w = np.array([c, c, c // 2, 3, 0], dtype=np.int32)
    Dt, Dj = _masked(D, w, "float64")
    assert np.array_equal(Dt.numpy(), np.asarray(Dj))
    L, Linv = (x.numpy() for x in dense.cholesky_inverse(Dt))
    Lj, Linvj = (np.asarray(x) for x in _jchol(Dj))
    assert np.max(np.abs(L - Lj)) <= 1e-10
    assert np.max(np.abs(Linv - Linvj)) <= 1e-10
    # and both are the factor and its inverse
    ref = np.linalg.cholesky(D[:2])
    assert np.allclose(L[:2], ref, atol=1e-8)
    assert np.allclose(Linv[:2] @ ref, np.eye(c)[None], atol=1e-8)
    k = c // 2
    assert np.allclose(L[2][:k, :k], np.linalg.cholesky(D[2][:k, :k]),
                       atol=1e-8)
    assert np.all(np.triu(L, 1) == 0) and np.all(np.triu(Linv, 1) == 0)
    # a w = 0 lane is exactly identity
    assert np.array_equal(L[4], np.eye(c))
    assert np.array_equal(Linv[4], np.eye(c))


@pytest.mark.parametrize("c", [16, 32, 128])
def test_f32_matches_jax_and_pallas_interpret(c):
    """f32: random masked lanes (w = 0 included) and, at the executor's
    widths, cond 1e5 lanes; against the JAX dense chain and the Pallas
    kernel run in interpret mode."""
    rng = np.random.default_rng(3)
    P = 6
    w = rng.integers(0, c + 1, P).astype(np.int32)
    w[0] = 0
    D = _rand_spd(rng, P, c)
    nill = 2 if c >= 32 else 0
    if nill:
        D = np.concatenate([D, _ill_conditioned(rng, nill, c)])
        w = np.concatenate([w, np.full(nill, c, dtype=np.int32)])
    Dt, Dj = _masked(D, w, "float32")
    L, Linv = (x.numpy() for x in dense.cholesky_inverse(Dt))
    refs = [_jchol(Dj),
            cholesky_inverse_pallas(Dj, tile_p=len(w), interpret=True)]
    for Lr, Linvr in ([np.asarray(x) for x in r] for r in refs):
        assert np.max(np.abs(L - Lr)) <= 1e-5 * c
        assert np.max(np.abs(Linv[:P] - Linvr[:P])) <= 1e-5
        if nill:
            assert (np.max(np.abs(Linv[P:] - Linvr[P:]))
                    <= 1e-3 * np.abs(Linvr[P:]).max())
    if nill:
        L64 = L[P:].astype(np.float64)
        Dill = D[P:]
        res = np.linalg.norm(L64 @ np.swapaxes(L64, 1, 2) - Dill,
                             axis=(1, 2))
        assert np.all(res / np.linalg.norm(Dill[0]) < 1e-4)
        err = np.linalg.norm(Linv[P:].astype(np.float64) @ L64
                             - np.eye(c)[None], axis=(1, 2))
        assert np.all(err < 1e-1), err


def test_rejects_bad_width():
    with pytest.raises(ValueError):
        dense.cholesky_inverse(torch.zeros((2, 24, 24)))
    with pytest.raises(ValueError):
        jdense.cholesky_inverse(jnp.zeros((2, 24, 24)))


def test_non_spd_gives_nan_in_both():
    c = 16
    rng = np.random.default_rng(5)
    D = _rand_spd(rng, 2, c)
    D[1, 3, 3] = -1.0                   # a negative pivot in lane 1
    L, Linv = (x.numpy() for x in
               dense.cholesky_inverse(torch.as_tensor(D)))
    Lj, Linvj = (np.asarray(x) for x in _jchol(jnp.asarray(D)))
    for X in (L, Linv, Lj, Linvj):
        assert np.all(np.isfinite(X[0]))
        assert np.isnan(X[1]).any()
    assert np.max(np.abs(L[0] - Lj[0])) <= 1e-10


def test_empty_batch():
    L, Linv = dense.cholesky_inverse(torch.zeros((0, 32, 32)))
    assert L.shape == Linv.shape == (0, 32, 32)


@pytest.mark.parametrize("c", [8, 16, 32, 48, 128])
def test_panels_mirror_matches_jax(c):
    """The CUDA kernel's block order in plain PyTorch
    (``cholesky_inverse_panels``) against the JAX dense chain: f64 within
    1e-10, f32 within 1e-5*c on L and 1e-5 on Linv; w = 0 lanes exactly
    identity; only the lower triangle is read."""
    rng = np.random.default_rng(11)
    D = _rand_spd(rng, 5, c)
    w = np.array([0, c, c, c // 2, 1], dtype=np.int32)
    for dtype, tol in (("float64", 1e-10), ("float32", 1e-5)):
        Dt, Dj = _masked(D, w, dtype)
        Lj, Linvj = (np.asarray(x) for x in _jchol(Dj))
        upper = torch.triu(torch.full_like(Dt, 123.0), 1)
        L, Linv = (x.numpy() for x in
                   dense.cholesky_inverse_panels(torch.tril(Dt) + upper))
        bar_l = tol if dtype == "float64" else tol * c
        assert np.max(np.abs(L - Lj)) <= bar_l
        assert np.max(np.abs(Linv - Linvj)) <= tol
        assert np.array_equal(L[0], np.eye(c))
        assert np.array_equal(Linv[0], np.eye(c))
        assert np.all(np.triu(L, 1) == 0) and np.all(np.triu(Linv, 1) == 0)


@pytest.mark.parametrize("c", [16, 48])
def test_panels_mirror_negative_pivot_gives_nan(c):
    rng = np.random.default_rng(12)
    D = torch.as_tensor(_rand_spd(rng, 2, c))
    D[1, 3, 3] = -1.0
    L, Linv = dense.cholesky_inverse_panels(D)
    for X in (L, Linv):
        assert torch.isfinite(X[0]).all()
        assert torch.isnan(X[1]).any()


def _chol_factor(rng, t):
    """A well-conditioned (t, t) lower-triangular factor, as the dense top
    gathers from a Cholesky factor."""
    M = rng.standard_normal((t, t))
    return np.linalg.cholesky(M @ M.T / t + np.eye(t))


@pytest.mark.parametrize("t", [5, 256, 300, 700])
def test_dense_tri_inv_matches_jax(t):
    """The dense top's inverse: the same bisection as the JAX
    ``dense_tri_inv`` (t = 5 and 256 are base cases, 300 and 700 split),
    f64 within 1e-10 (and T Tinv = I within 1e-10), f32 within 1e-4 of
    the largest |entry|."""
    T = _chol_factor(np.random.default_rng(t), t)
    for dtype, jdt in (("float64", jnp.float64), ("float32", jnp.float32)):
        Tj = np.asarray(jdense.dense_tri_inv(jnp.asarray(T.astype(dtype),
                                                         dtype=jdt)))
        Tp = dense.dense_tri_inv(torch.as_tensor(T.astype(dtype))).numpy()
        assert Tp.dtype == np.dtype(dtype)
        if dtype == "float64":
            assert np.max(np.abs(Tp - Tj)) <= 1e-10
            assert np.max(np.abs(T @ Tp - np.eye(t))) <= 1e-10
            assert np.all(np.triu(Tp, 1) == 0)
        else:
            assert np.max(np.abs(Tp - Tj)) <= 1e-4 * np.abs(Tj).max()


def test_tri_solves_and_finalize_panel_match_jax_f64():
    """``tri_inverse``, ``tri_lower_solve``, ``tri_lower_solve_t`` and
    ``finalize_panel`` against the JAX functions of the same names, f64
    within 1e-10, on full, partly masked and w = 0 lanes."""
    rng = np.random.default_rng(13)
    c, H = 32, 80
    D = _rand_spd(rng, 4, c)
    w = np.array([c, 20, 0, 1], dtype=np.int32)
    L = np.linalg.cholesky(_rand_spd(rng, 4, c))
    b = rng.standard_normal((4, c))
    Lt, bt, Lj, bj = (torch.as_tensor(L), torch.as_tensor(b),
                      jnp.asarray(L), jnp.asarray(b))
    for port, ref in (
            (dense.tri_inverse(Lt), jdense.tri_inverse(Lj)),
            (dense.tri_lower_solve(Lt, bt), jdense.tri_lower_solve(Lj, bj)),
            (dense.tri_lower_solve_t(Lt, bt),
             jdense.tri_lower_solve_t(Lj, bj))):
        assert port.shape == ref.shape
        assert np.max(np.abs(port.numpy() - np.asarray(ref))) <= 1e-10
    G = rng.standard_normal((4, H, c))
    G[:, :c, :] = D
    port = dense.finalize_panel(torch.as_tensor(G), torch.as_tensor(w), c,
                                torch.float64).numpy()
    ref = np.asarray(jdense.finalize_panel(jnp.asarray(G), jnp.asarray(w), c,
                                           jnp.float64))
    assert port.shape == (4, H, c)
    assert np.max(np.abs(port - ref)) <= 1e-10
