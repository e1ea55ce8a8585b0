"""The probes' CUDA source (csrc/probes.cu) compiled with g++ against the
CPU stand-in of tools/cuda_emu/cuda_runtime.h, held against the plain
versions of ``parsy_bench_tpu_torch/probes.py`` and against numpy
restatements of the TPU probes' arithmetic (scripts/pallas_gather_probe.py
sums 8-row packed blocks at PER starts; scripts/pallas_probe.py copies a
tile), on seeded numpy inputs.  This runs P3's own indexing (teams of
lanes per 16-byte column chunk, the sub-teams over a group's rows and
their partial sums in shared memory) without a card; its speed is
measured only on the card (chip_smoke.py phase 10).

Cases: the probe's layout at a reduced size (8c = 256, per = 32) and at
its own width (8c = 1,024) with G below the card's 132 SMs; the
executor's ladder sums (c = 32 with m = 1, 8, 64; c = 128 with m = 4,
128) on a call buffer whose row 0 is the zero row, with padded slots
pointing there; per not a multiple of the kernel's load depth (8); very
long groups; a grid large enough to split groups less; a width that is
not a power of two; an out-of-range index, which must poison its group
and no other.
Bar: 1e-5 of the largest |sum| (chip_smoke.py's), against float64 sums.
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
    lib = mod.build("probes.cu", tmp_path_factory.mktemp("p3_emu"))
    return mod, lib


def _check(emu, pool, idx, per):
    """The emulated kernel against the plain version and float64 sums;
    returns the kernel's output."""
    mod, lib = emu
    out = mod.gather_sum(lib, pool, idx, per)
    G, w = idx.size // per, pool.shape[1]
    ref = pool[idx].reshape(G, per, w).astype(np.float64).sum(1)
    plain = probes.gather_sum_plain(torch.as_tensor(pool),
                                    torch.as_tensor(idx), per).numpy()
    bar = 1e-5 * np.abs(ref).max()
    assert out.shape == (G, w)
    assert np.abs(out - ref).max() <= bar
    assert np.abs(out - plain).max() <= bar
    return out


@pytest.mark.parametrize("c,G", [(32, 16), (128, 5)],
                         ids=["8c=256", "8c=1024,G<SMs"])
def test_probe_layout(emu, c, G):
    """The TPU probe: packed 8-row blocks of width c at per = 32 uniform
    starts; group g sums pool[8 r : 8 r + 8] over its starts r, and the
    last group is the TPU kernel's one output."""
    rows, per = 8 * 64, probes.PER
    rng = np.random.default_rng(c)
    pool = rng.standard_normal((rows, c)).astype(np.float32)
    idx = probes.gather_indices(rows, G * per, seed=c)
    out = _check(emu, pool.reshape(rows // 8, 8 * c), idx, per)
    ref = np.zeros((G, 8, c))
    for g in range(G):
        for k in range(per):
            r = idx[g * per + k]
            ref[g] += pool[8 * r:8 * r + 8].astype(np.float64)
    out = out.reshape(G, 8, c)
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
    via_probe = probes.gather_plain(
        torch.as_tensor(pool.reshape(rows // 8, 8 * c)),
        torch.as_tensor(idx), per).numpy()
    assert np.abs(out[-1] - via_probe[-1]).max() <= 1e-5 * np.abs(ref).max()


def _ladder(rng, c, m, R, ntot):
    """A call buffer (ntot + 1, c) with the zero row first, and an (R, m)
    ladder table as splan._build_gather_tables lays it out: each group's
    real sources (+1), its padded slots 0."""
    call = rng.standard_normal((ntot + 1, c)).astype(np.float32)
    call[0] = 0.0
    gi = np.zeros((R, m), dtype=np.int32)
    for r in range(R):
        cnt = int(rng.integers(m // 2 + 1, m + 1))
        gi[r, :cnt] = rng.choice(ntot, cnt, replace=False) + 1
    return call, gi


@pytest.mark.parametrize("c,m,R", [(32, 1, 300), (32, 8, 70), (32, 64, 9),
                                   (128, 4, 40), (128, 128, 3)])
def test_ladder_shapes(emu, c, m, R):
    rng = np.random.default_rng(c * 1000 + m)
    call, gi = _ladder(rng, c, m, R, ntot=max(600, m + 1))
    out = _check(emu, call, gi.reshape(-1), m)
    ref = torch.as_tensor(call)[torch.as_tensor(gi)].sum(dim=1).numpy()
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("w,per,G", [(32, 13, 4), (128, 100, 4),
                                     (128, 9, 4), (12, 13, 4),
                                     (4, 5000, 2), (128, 64, 600)],
                         ids=["w32-per13", "w128-per100", "w128-per9",
                              "w12", "w4-per5000", "G600-fewer-splits"])
def test_per_and_widths(emu, w, per, G):
    """per not a multiple of the load depth 8 (13, 100, 9); w = 12 (three
    16-byte columns in a team of four lanes); per = 5,000 at w = 4 (1,024
    one-lane sub-teams of 5 rows); 600 groups of 64 at w = 128, where the
    grid is large enough that a group's rows are split over 4 sub-teams
    rather than 8."""
    rng = np.random.default_rng(w + per)
    rows = 300
    pool = rng.standard_normal((rows, w)).astype(np.float32)
    idx = rng.integers(0, rows, G * per).astype(np.int32)
    _check(emu, pool, idx, per)


@pytest.mark.parametrize("bad", [-1, 300])
def test_out_of_range_index_poisons_its_group_only(emu, bad):
    mod, lib = emu
    rng = np.random.default_rng(7)
    rows, w, G, per = 300, 128, 6, 32
    pool = rng.standard_normal((rows, w)).astype(np.float32)
    idx = rng.integers(0, rows, G * per).astype(np.int32)
    idx[2 * per + 5] = bad
    out = mod.gather_sum(lib, pool, idx, per)
    assert np.isnan(out[2]).all()
    good = np.delete(np.arange(G), 2)
    assert np.isfinite(out[good]).all()
    keep = np.delete(idx.reshape(G, per), 2, axis=0)
    ref = pool[keep].astype(np.float64).sum(1)
    assert np.abs(out[good] - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("n,offset", [(1024, 0), (1027, 0), (1024, 1),
                                      (3, 0)])
def test_copy_is_bit_equal(emu, n, offset):
    """P1 at the probe's 8 x 128 tile, with a tail of 3, from a pointer
    off 16-byte alignment (the scalar path) and below one vector."""
    mod, lib = emu
    x = np.random.default_rng(n).standard_normal(n + offset) \
        .astype(np.float32)[offset:]
    y = mod.probe_copy(lib, x)
    assert np.array_equal(y.view(np.int32), x.view(np.int32))

