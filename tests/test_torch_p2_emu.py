"""P2, the f32 matrix product of csrc/probes.cu (3xTF32 on the tensor
cores), compiled with g++ against the CPU stand-in of
tools/cuda_emu/cuda_runtime.h (the mma.m16n8k8 TF32 fragments exchanged
within a warp, the wgmma m64nNk8 A fragments within the warpgroup and its
B read through the shared-memory descriptor, cvt.rna.tf32 as a bit
operation, bulk copies and cp.async as plain copies) and held against a
float64 product and the plain version of
``parsy_bench_tpu_torch/probes.py`` on seeded numpy inputs.
This runs P2's fragment maps, its lane packing, its column splits and its
zero-filled edges without a card; its speed is measured only on the card
(chip_smoke.py phase 10).

Cases: the TPU probe's 128 x 128 product (scripts/pallas_probe.py) on
random values and on ones @ 2I, which must be exactly 2; ragged 37 x 21 @
21 x 45 (rows that are not 16-byte aligned); B stored as (K, N) and as
(N, K); the update products of ``ops/supernodal.update_block`` at a few
lanes, A B_raw^T at (Mc, K, Q) = (16, 32, 16), (64, 128, 48) and (256,
128, 136) and the one-hot Chat S^T with a 0/1 S; K = 136; L = 1 and L =
5; enough lanes of 16 rows that a block takes four lanes; the 64-row
wgmma tiles (M >= 64, N >= 96, 64 <= K <= 136) at M, N and K that are
not multiples of 64, 64 and 8; and a depth of 2,000, which a block walks
in two rounds of its shared-memory budget.
Bars: |C - C64| <= 1e-5 K max|a| max|b| (the probe's) and, entrywise,
<= 2^-16 sum_k |a_ik b_kj| (``probes.MATMUL_REL_BAR``, which a single TF32
pass exceeds).
"""
import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from parsy_bench_tpu_torch import probes

torch.set_num_threads(1)

_EMU = Path(__file__).resolve().parents[1] / "tools" / "cuda_emu"

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="the CPU stand-in is built with g++")


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    spec = importlib.util.spec_from_file_location("cuda_emu", _EMU / "emu.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lib = mod.build("probes.cu", tmp_path_factory.mktemp("p2_emu"))
    return mod, lib


def _random(L, M, N, K, trans_b, seed):
    """a (L, M, K) and b (L, N, K) with ``trans_b``, else (L, K, N); L = 0
    gives 2-D operands."""
    rng = np.random.default_rng(seed)
    lead = (L,) if L else ()
    a = rng.standard_normal(lead + (M, K)).astype(np.float32)
    b = rng.standard_normal(lead + ((N, K) if trans_b else (K, N))) \
        .astype(np.float32)
    return a, b


def _one_hot(L, Mc, Q, c, seed):
    """The second update product's operands: Chat (L, Mc, Q) and the
    column selector S (L, c, Q), S[l, j, q] = (colq[l, q] == j), with some
    columns padded (colq = c: no target column)."""
    rng = np.random.default_rng(seed)
    chat = rng.standard_normal((L, Mc, Q)).astype(np.float32)
    colq = rng.integers(0, c + 1, (L, Q))
    S = (np.arange(c)[None, :, None] == colq[:, None, :]).astype(np.float32)
    return chat, S


def _ones_2i(n=128):
    return np.ones((n, n), np.float32), 2.0 * np.eye(n, dtype=np.float32)


#: id -> (a, b, trans_b)
CASES = {
    "probe-128": _random(0, 128, 128, 128, False, 1) + (False,),
    "probe-ones@2I": _ones_2i() + (False,),
    "37x21@21x45": _random(0, 37, 45, 21, False, 3) + (False,),
    "B(K,N)-L5": _random(5, 20, 24, 36, False, 4) + (False,),
    "B(N,K)-L5": _random(5, 20, 24, 36, True, 5) + (True,),
    "update-16-32-16": _random(3, 16, 16, 32, True, 6) + (True,),
    "update-64-128-48": _random(2, 64, 48, 128, True, 7) + (True,),
    "update-256-128-136": _random(1, 256, 136, 128, True, 8) + (True,),
    "one-hot-64x48-c32": _one_hot(3, 64, 48, 32, 9) + (True,),
    "one-hot-16x136-c128": _one_hot(2, 16, 136, 128, 10) + (True,),
    "one-hot-64x136-c128": _one_hot(2, 64, 136, 128, 14) + (True,),
    "K136-L1": _random(1, 64, 128, 136, True, 11) + (True,),
    "64-row-tiles-ragged": _random(3, 100, 120, 100, True, 13) + (True,),
    "K2000-in-rounds": _random(1, 16, 8, 2000, True, 15) + (True,),
    "packed-2200-lanes-16x16x32": _random(2200, 16, 16, 32, True, 12)
    + (True,),
}


@pytest.mark.parametrize("case", list(CASES))
def test_matmul(emu, case):
    mod, lib = emu
    a, b, trans_b = CASES[case]
    out = mod.matmul(lib, a, b, trans_b)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    plain = probes.matmul_plain(ta, tb, trans_b)
    assert out.shape == tuple(plain.shape)
    err, bar, rel = probes.matmul_error(torch.as_tensor(out), ta, tb,
                                        trans_b)
    assert err <= bar
    assert rel <= probes.MATMUL_REL_BAR
    assert np.abs(out - plain.numpy()).max() <= bar
    if case == "probe-ones@2I":
        assert np.array_equal(out, np.full_like(out, 2.0))
