"""K1's CUDA source (csrc/chol_inverse.cu, csrc/chol_blocked.cuh) compiled
with g++ against the CPU stand-in of tools/cuda_emu/cuda_runtime.h, held
against the JAX package's dense Cholesky + inverse on the same numpy
inputs.  This runs the kernel's own indexing, barriers and shuffles
without a card; its speed is measured only on the card (chip_smoke.py).

Tolerances as for the plain version (tests/test_torch_dense.py): f64
1e-10 on L and Linv; f32 1e-5*c on L and 1e-5 on Linv.  Padded (w = 0)
lanes must come out exactly identity, nothing above the diagonal may be
written or read, and a negative pivot must give NaN.
"""
import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import torch

from parsy_bench_tpu.ops import dense as jdense
from parsy_bench_tpu_torch.ops import dense

_EMU = Path(__file__).resolve().parents[1] / "tools" / "cuda_emu"

#: every width class K1 takes: any c <= 16, multiples of 16 up to 128;
#: c <= 32 runs the one-warp kernel, c > 32 the blocked one
WIDTHS = [5, 8, 16, 32, 48, 64, 96, 112, 128]

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="the CPU stand-in is built with g++")


def _masked_blocks(rng, P, c, dtype):
    """P random masked-SPD blocks (c, c): logical widths drawn in [0, c]
    with lane 0 all padding (w = 0) and lane 1 full.  Returns the blocks
    as the kernel sees them, with the strict upper triangle set to 123
    (the kernel must not read it), and their symmetric form."""
    A = rng.standard_normal((P, c, c))
    D0 = A @ A.transpose(0, 2, 1) + c * np.eye(c)
    w = rng.integers(0, c + 1, P).astype(np.int32)
    w[0], w[1] = 0, c
    D = dense.masked_spd(torch.as_tensor(D0.astype(dtype)),
                         torch.as_tensor(w), c,
                         getattr(torch, np.dtype(dtype).name)).numpy()
    Dk = D.copy()
    iu = np.triu_indices(c, 1)
    Dk[:, iu[0], iu[1]] = 123.0
    return Dk, D


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    spec = importlib.util.spec_from_file_location("cuda_emu", _EMU / "emu.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lib = mod.build("chol_inverse.cu", tmp_path_factory.mktemp("k1_emu"))
    return mod, lib


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("c", WIDTHS)
def test_emulated_k1_matches_jax(emu, c, dtype):
    mod, lib = emu
    dt = np.dtype(dtype).type
    # two CTAs of four warps at c <= 32; three blocks of the blocked kernel
    P = 6 if c <= 32 else 3
    Dk, D = _masked_blocks(np.random.default_rng(c), P, c, dt)
    L, Linv = mod.chol_inverse(lib, Dk)
    Lj, Linvj = (np.asarray(x) for x in
                 jax.jit(jdense.cholesky_inverse)(jnp.asarray(D)))
    tol = 1e-10 if dtype == "float64" else 1e-5
    bar_l = tol if dtype == "float64" else tol * c
    assert np.max(np.abs(L - Lj)) <= bar_l
    assert np.max(np.abs(Linv - Linvj)) <= tol
    eye = np.eye(c)
    assert np.array_equal(L[0], eye) and np.array_equal(Linv[0], eye)
    assert not np.triu(L, 1).any() and not np.triu(Linv, 1).any()
    L64, Linv64 = L.astype(np.float64), Linv.astype(np.float64)
    res = (np.linalg.norm(L64 @ L64.transpose(0, 2, 1) - D, axis=(1, 2))
           / np.linalg.norm(D, axis=(1, 2)))
    assert res.max() < 1e-5
    assert np.linalg.norm(Linv64 @ L64 - eye, axis=(1, 2)).max() < 1e-4


@pytest.mark.parametrize("c", WIDTHS)
def test_emulated_k1_negative_pivot_gives_nan(emu, c):
    mod, lib = emu
    D = np.stack([4.0 * np.eye(c)] * 2).astype(np.float32)
    D[1, c // 2, c // 2] = -1.0
    L, Linv = mod.chol_inverse(lib, D)
    assert np.isfinite(L[0]).all() and np.isfinite(Linv[0]).all()
    assert np.isnan(L[1]).any() and np.isnan(Linv[1]).any()
