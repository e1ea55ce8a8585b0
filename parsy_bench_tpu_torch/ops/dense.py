"""Batched dense Cholesky + triangular inverse, and the fused finalize, in
plain PyTorch.

Counterpart of ``parsy_bench_tpu/ops/dense.py`` with the same algorithm:
a flat right-looking Cholesky in 16-wide panels, an unrolled rank-2 pivot
chain per panel, the panel TRSM as a product with the panel's
Neumann-product inverse, and the full triangular inverse as a finite
Neumann product.  It is the plain version of the hand-written CUDA kernel
(``parsy_bench_tpu_torch/csrc/chol_inverse.cu``): CPU tensors run it, and
tests and ``chip_smoke.py`` compare the kernel against it.  The same holds
for ``finalize_fused``, the whole per-bucket finalize, and its kernel
``csrc/finalize_fused.cu``.  ``cholesky_inverse_panels`` computes the same
function in the kernel's own block order (tests only).  ``dense_tri_inv``
inverts the one dense triangular block of a plan's dense top
(``SupernodalExecutor.top_inverse``); ``finalize_panel``,
``tri_lower_solve``, ``tri_lower_solve_t`` and ``tri_inverse`` complete
the JAX module's set.  Their products are ``torch.bmm``/``torch.matmul``
in full precision, as the JAX package's are XLA dots outside any Pallas
kernel.

All functions are batched over a leading ``P`` axis and take a *masked*
SPD block: rows/columns beyond the logical width carry an identity
diagonal (see ``masked_spd``), so padded lanes factor to identity.  A
non-positive pivot gives NaN through ``sqrt``, which the solver's
``factor_ok`` check relies on.
"""
from __future__ import annotations

import torch

#: panel width of the flat blocked Cholesky (rank-1 chain length per panel)
_PANEL = 16


def _tril_mask(c, device, k=0):
    i = torch.arange(c, device=device)[:, None]
    j = torch.arange(c, device=device)[None, :]
    return (j <= i + k)[None]


def nilpotent_inv(L):
    """Triangular inverse via the finite Neumann product.

    For lower-triangular L (P, c, c) with nonzero diagonal, L = D(I + N)
    with N strictly lower, so (I + N)^{-1} = prod_j (I + M^(2^j)),
    M = -N: log2(c) squarings and products."""
    P, c, _ = L.shape
    d = torch.diagonal(L, dim1=1, dim2=2)                 # (P, c)
    M = -(L / d[:, :, None])
    M = M.masked_fill(~_tril_mask(c, L.device, -1), 0)
    acc = torch.eye(c, dtype=L.dtype, device=L.device)[None] + M
    k = 2
    while k < c:
        M = torch.bmm(M, M)
        acc = acc + torch.bmm(acc, M)
        k *= 2
    return acc / d[:, None, :]


def masked_spd(D, w, c, dtype):
    """Mask a gathered (P, c, c) block to its logical width ``w`` (P,):
    keep the valid symmetric part, identity on the padded diagonal."""
    ar = torch.arange(c, device=D.device)
    i = ar[None, :, None]
    j = ar[None, None, :]
    wv = w[:, None, None]
    valid = (i < wv) & (j < wv)
    D = D.to(dtype).masked_fill(~(valid & (j <= i)), 0)
    strict = D.masked_fill(~(j < i), 0)
    D = D + strict.transpose(1, 2)
    eye_pad = ((i == j) & (i >= wv)).to(dtype)
    return D + eye_pad


def _chol_panel(D, pw):
    """Unrolled rank-2 Cholesky chain for a (P, pw, pw) masked SPD block:
    two columns per step through the closed-form 2x2 pivot."""
    n = pw
    cols = []
    ar = torch.arange(n, device=D.device)
    j = 0
    while j < n:
        if j + 1 < n:
            a = D[:, j, j]
            l11 = torch.sqrt(a)
            cj = (D[:, :, j] / l11[:, None]) * (ar >= j)
            l21 = cj[:, j + 1]
            c22 = D[:, j + 1, j + 1] - l21 * l21
            l22 = torch.sqrt(c22)
            cj1 = ((D[:, :, j + 1] - cj * l21[:, None])
                   / l22[:, None]) * (ar >= j + 1)
            cols.extend([cj, cj1])
            D = D - (cj[:, :, None] * cj[:, None, :]
                     + cj1[:, :, None] * cj1[:, None, :])
            j += 2
        else:
            d = torch.sqrt(D[:, j, j])
            cvec = (D[:, :, j] / d[:, None]) * (ar >= j)
            cols.append(cvec)
            D = D - cvec[:, :, None] * cvec[:, None, :]
            j += 1
    return torch.stack(cols, dim=2)


def cholesky_inverse(D):
    """Batched blocked Cholesky with inverse: D (P, c, c) masked SPD ->
    (L, Linv), both lower triangular.

    Per 16-wide panel: the rank-2 chain on the diagonal block, one small
    ``nilpotent_inv`` for the panel TRSM, and one rank-16 trailing update;
    the full Linv comes from one ``nilpotent_inv`` at the end."""
    P, c, _ = D.shape
    if c <= _PANEL:
        L = _chol_panel(D, c)
        return L, nilpotent_inv(L)
    if c % _PANEL:
        # the panel loop slices fixed 16-wide panels
        raise ValueError(f"width class {c} is not a multiple of {_PANEL}")
    L = torch.zeros_like(D)
    A = D.clone()
    for j0 in range(0, c, _PANEL):
        j1 = j0 + _PANEL
        Lp = _chol_panel(A[:, j0:j1, j0:j1], _PANEL)
        iLp = nilpotent_inv(Lp)
        L[:, j0:j1, j0:j1] = Lp
        if j1 < c:
            below = torch.bmm(A[:, j1:, j0:j1], iLp.transpose(1, 2))
            L[:, j1:, j0:j1] = below
            A[:, j1:, j1:] -= torch.bmm(below, below.transpose(1, 2))
    return L, nilpotent_inv(L)


def _chol_inverse_warp(A):
    """The CUDA kernel's one-warp routine on (P, n, n) blocks, n <= 32,
    lower triangle read: one loop of n steps, each taking a column of the
    right-looking Cholesky (pivot through ``rsqrt``, as the kernel does)
    and the matching step of the forward substitution for Linv
    (``X[:, :, j]`` is lane j's column)."""
    P, n, _ = A.shape
    A = A.clone()
    L = torch.zeros_like(A)
    X = torch.zeros_like(A)
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    for k in range(n):
        piv = A[:, k, k]
        inv = torch.rsqrt(piv)
        v = A[:, k + 1:, k] * inv[:, None]
        L[:, k, k] = piv * inv
        L[:, k + 1:, k] = v
        X[:, k, :] = (eye[k] - X[:, k, :]) * inv[:, None]
        A[:, k + 1:, k + 1:] -= v[:, :, None] * v[:, None, :]
        X[:, k + 1:, :] += v[:, :, None] * X[:, k, None, :]
    return L, torch.tril(X)


def cholesky_inverse_panels(D, panel=32):
    """``cholesky_inverse`` in the CUDA kernel's block order
    (``csrc/chol_inverse.cu``), for rehearsing that design on the CPU; the
    solver does not call it.  Per ``panel``-wide panel: the one-warp routine
    on the diagonal block (``_chol_inverse_warp``), the TRSM as a product
    with the panel's inverse, the trailing update; then Linv by block
    forward substitution, Linv_IJ = -Linv_II sum_K L_IK Linv_KJ, one block
    row after another.  Only the lower triangle of D is read."""
    P, c, _ = D.shape
    A = torch.tril(D)
    L = torch.zeros_like(D)
    Linv = torch.zeros_like(D)
    starts = range(0, c, panel)
    for j0 in starts:
        j1 = min(j0 + panel, c)
        L11, I11 = _chol_inverse_warp(A[:, j0:j1, j0:j1])
        L[:, j0:j1, j0:j1] = L11
        Linv[:, j0:j1, j0:j1] = I11
        if j1 < c:
            L21 = torch.bmm(A[:, j1:, j0:j1], I11.transpose(1, 2))
            L[:, j1:, j0:j1] = L21
            A[:, j1:, j1:] -= torch.bmm(L21, L21.transpose(1, 2))
    for i0 in starts[1:]:
        i1 = min(i0 + panel, c)
        for j0 in range(0, i0, panel):
            # Linv_KJ is zero for K < J, so the sum may start at column j0
            T = torch.bmm(L[:, i0:i1, j0:i0], Linv[:, j0:i0, j0:j0 + panel])
            Linv[:, i0:i1, j0:j0 + panel] = -torch.bmm(
                Linv[:, i0:i1, i0:i1], T)
    return L, Linv


def finalize_diff(blk, w, cnt, L, Linv):
    """The finalize tail of one bucket, given the factor of its masked top:
    blk (P, H, c) window block, w (P,) logical widths, cnt true lanes,
    (L, Linv) of ``masked_spd(blk[:, :c, :], w)`` -> the lane-masked diff
    (P, H, c) to add onto the window.

    Top rows i < w become Ltop: L on the valid w x w part, with Linv^T in
    its strict upper triangle (the solves read it back); every other row
    becomes Y = blk Linv^T on the columns j < w, zero beyond.  Lanes at or
    beyond cnt get zero."""
    P, H, c = blk.shape
    ar = torch.arange(c, device=blk.device)
    i_c = ar[None, :, None]
    j_c = ar[None, None, :]
    wv = w[:, None, None]
    valid = (i_c < wv) & (j_c < wv)
    LinvT = Linv.transpose(1, 2)
    Ltop = (L.masked_fill(~valid, 0)
            + LinvT.masked_fill(~(valid & (j_c > i_c)), 0))
    Y = torch.bmm(blk, LinvT).masked_fill(~(j_c < wv), 0)
    top = torch.where(i_c < wv, Ltop, Y[:, :c, :])
    diff = torch.cat([top, Y[:, c:, :]], dim=1) - blk
    diff[int(cnt):] = 0
    return diff


def finalize_fused(blk, w, cnt):
    """The whole per-bucket finalize: masked-SPD build of the top c x c,
    Cholesky + inverse, and ``finalize_diff``.  blk (P, H, c), w (P,)
    int32, cnt a host integer -> diff (P, H, c).  Counterpart of
    ``pallas_kernels._finalize_body``; the plain version of the CUDA
    kernel ``csrc/finalize_fused.cu``."""
    c = blk.shape[2]
    if blk.shape[1] < c:
        raise ValueError(f"bucket height {blk.shape[1]} below its width {c}")
    L, Linv = cholesky_inverse(masked_spd(blk[:, :c, :], w, c, blk.dtype))
    return finalize_diff(blk, w, cnt, L, Linv)


def finalize_panel(G, w, c, dtype):
    """One supernode-panel finalization (dpotrf + dtrsm as GEMM).

    G: (P, H, c) assembled panel (diag block on top).  Returns the
    factored panel: rows [0, c) replaced by L (identity-padded columns
    zeroed), rows [c, H) by G_below @ L^{-T} on the columns j < w."""
    D = masked_spd(G[:, :c, :], w, c, dtype)
    L, Linv = cholesky_inverse(D)
    ar = torch.arange(c, device=G.device)
    wv = w[:, None, None]
    Ltop = L.masked_fill(~((ar[None, :, None] < wv)
                           & (ar[None, None, :] < wv)), 0)
    Y = torch.bmm(G[:, c:, :].to(dtype), Linv.transpose(1, 2))
    Y = Y.masked_fill(~(ar[None, None, :] < wv), 0)
    return torch.cat([Ltop, Y], dim=1)


def tri_lower_solve(L, b):
    """x = L^{-1} b for batched lower-triangular L (P, c, c), b (P, c),
    through the Neumann-product inverse."""
    return torch.bmm(nilpotent_inv(L), b[:, :, None])[:, :, 0]


def tri_lower_solve_t(L, b):
    """x = L^{-T} b."""
    return torch.bmm(nilpotent_inv(L).transpose(1, 2), b[:, :, None])[:, :, 0]


def tri_inverse(L):
    """Linv for batched lower-triangular L (P, c, c)."""
    return nilpotent_inv(L)


def dense_tri_inv(T, base: int = 256):
    """Explicit inverse of one (t, t) lower-triangular matrix by blocked
    bisection, inv([[A, 0], [B, C]]) = [[Ai, 0], [-Ci B Ai, Ci]], with the
    Neumann-product inverse at the base: the same splits ``h`` as the JAX
    ``dense_tri_inv``, O(t^3 / 3) flops in products.  Run once per
    factorization to prepare the dense-top solve block (the role of dtrsm
    on the peeled level, Triangular_BCSC.h:238); every solve then costs
    one (t, t) product.  Shapes depend on ``t`` only, so a captured
    program holds it."""
    t = T.shape[0]
    if t <= base:
        return nilpotent_inv(T[None])[0]
    h = max(((t // 2) + 127) // 128 * 128, base)
    if h >= t:
        h = t // 2
    Ai = dense_tri_inv(T[:h, :h], base)
    Ci = dense_tri_inv(T[h:, h:], base)
    out = torch.zeros_like(T)
    out[:h, :h] = Ai
    out[h:, :h] = -torch.matmul(Ci, torch.matmul(T[h:, :h], Ai))
    out[h:, h:] = Ci
    return out
