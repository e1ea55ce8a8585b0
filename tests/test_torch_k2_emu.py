"""K2's CUDA source (csrc/finalize_fused.cu on csrc/chol_blocked.cuh)
compiled with g++ against the CPU stand-in of tools/cuda_emu/cuda_runtime.h,
held against its plain version ``ops/dense.finalize_fused`` and, at one
small shape, against the TPU kernel ``finalize_fused_pallas`` in interpret
mode, on the same numpy inputs.  This runs the kernel's own indexing,
shuffles and barriers without a card; its speed is measured only on the
card (chip_smoke.py).

Both branches run: c <= 32 (one warp per unit) at c = 8, 16, 32 and the
blocked one at c = 48 and 64, each at H = c and at an H > c that is not a
multiple of 32, in the wrapper's row chunks, in one and in three.  Bars:
the card's, 1e-5 c max|entry| in f32 (chip_smoke.py), 1e-12 c max|entry|
in f64 (the plain version's 16-wide panels and the kernel's rsqrt chain
round differently).  Lanes at or beyond cnt must be exactly zero, lanes with w
clamped to 0 exactly -blk, and a negative pivot must give NaN.
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

from parsy_bench_tpu.ops.pallas_kernels import finalize_fused_pallas
from parsy_bench_tpu_torch.ops import dense, kernels

_EMU = Path(__file__).resolve().parents[1] / "tools" / "cuda_emu"

#: widths: c <= 32 the warp branch, c > 32 the blocked one
WIDTHS = [8, 16, 32, 48, 64]

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="the CPU stand-in is built with g++")


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    spec = importlib.util.spec_from_file_location("cuda_emu", _EMU / "emu.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lib = mod.build("finalize_fused.cu", tmp_path_factory.mktemp("k2_emu"))
    return mod, lib


def _bucket(rng, P, H, c, dtype):
    """A bucket (P, H, c) with SPD tops and widths: lane 0 full, lane 1
    w = 0, lane 2 w > c (clamped to c), lane 3 w < 0 (clamped to 0), lane
    4 w = 1 (most lanes of the fused leaf at laplace_3d(48)), the rest
    partial."""
    A = rng.standard_normal((P, c, c))
    blk = rng.standard_normal((P, H, c))
    blk[:, :c, :] = A @ A.transpose(0, 2, 1) + c * np.eye(c)
    w = rng.integers(1, c + 1, P).astype(np.int32)
    w[:5] = c, 0, c + 3, -2, 1
    return blk.astype(dtype), w


def _plain(blk, w, cnt):
    return dense.finalize_fused(torch.as_tensor(blk), torch.as_tensor(w),
                                cnt).numpy()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("tall", [False, True], ids=["H=c", "H>c"])
@pytest.mark.parametrize("c", WIDTHS)
def test_emulated_k2_matches_plain(emu, c, tall, dtype):
    mod, lib = emu
    P, cnt = 6, 5
    H = c + 13 if tall else c
    blk, w = _bucket(np.random.default_rng(c + tall), P, H, c,
                     np.dtype(dtype).type)
    ref = _plain(blk, w, cnt)
    bar = (1e-5 if dtype == "float32" else 1e-12) * c * np.abs(ref).max()
    for nchunk in {kernels.finalize_chunks(P, H, c), 1, 3}:
        diff = mod.finalize_fused(lib, blk, w, cnt, nchunk)
        assert diff.dtype == blk.dtype
        assert np.max(np.abs(diff - ref)) <= bar, nchunk
        assert np.array_equal(diff[cnt:], np.zeros_like(diff[cnt:]))
        for lane in (1, 3):                  # w = 0 and w < 0
            assert np.array_equal(diff[lane], -blk[lane])


@pytest.mark.parametrize("c", WIDTHS)
def test_emulated_k2_negative_pivot_gives_nan(emu, c):
    mod, lib = emu
    H = c + 9
    blk = np.zeros((2, H, c), np.float32)
    blk[:, :c, :] = 4.0 * np.eye(c)
    blk[:, c:, :] = 1.0
    blk[1, c // 2, c // 2] = -1.0
    diff = mod.finalize_fused(lib, blk, np.full(2, c, np.int32), 2,
                              kernels.finalize_chunks(2, H, c))
    assert np.isfinite(diff[0]).all()
    assert np.isnan(diff[1]).any()
    ref = _plain(blk[:1], np.full(1, c, np.int32), 1)[0]
    assert np.max(np.abs(diff[0] - ref)) <= 1e-5 * c * np.abs(ref).max()


def test_emulated_k2_matches_pallas_interpret(emu):
    """At one small shape, against the TPU kernel itself (interpret
    mode, tp = 2), f32 within the JAX test's bar 1e-4."""
    mod, lib = emu
    P, H, c, cnt = 6, 45, 16, 5
    blk, w = _bucket(np.random.default_rng(11), P, H, c, np.float32)
    w[2:4] = c, 5                    # the TPU kernel takes w in [0, c]
    ref = np.asarray(finalize_fused_pallas(
        jnp.asarray(blk), jnp.asarray(w), jnp.int32(cnt), tp=2,
        interpret=True))
    diff = mod.finalize_fused(lib, blk, w, cnt,
                              kernels.finalize_chunks(P, H, c))
    assert np.max(np.abs(diff - ref)) < 1e-4
