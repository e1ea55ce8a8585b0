"""The probes' plain versions (``parsy_bench_tpu_torch/probes.py``) against
numpy restatements of the TPU probes' arithmetic (scripts/pallas_probe.py,
scripts/pallas_gather_probe.py), and the probe entry point without a card.

The JAX probe kernels use TPU memory spaces and run only on a TPU; the
CUDA kernels run only on the card, where ``chip_smoke.py`` and
``python -m parsy_bench_tpu_torch.probes`` hold them against these plain
versions.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from parsy_bench_tpu_torch import probes
from parsy_bench_tpu_torch.ops import kernels

# one intra-op thread per test process: the suite runs several pytest
# workers at once, and torch's default pool (one thread per core) in each
# of them oversubscribes the cores many times over on these small ops
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_copy_plain_is_exact():
    x = torch.arange(1024, dtype=torch.float32).reshape(8, 128)
    y = probes.probe_copy(x)
    assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()


def test_matmul_plain():
    # the TPU probe's case: ones @ 2I is exactly 2
    out = probes.probe_matmul(torch.ones((128, 128)),
                              2.0 * torch.eye(128))
    assert torch.equal(out, torch.full((128, 128), 2.0))
    rng = np.random.default_rng(1)
    a = rng.standard_normal((128, 128)).astype(np.float32)
    b = rng.standard_normal((128, 128)).astype(np.float32)
    out = probes.probe_matmul(torch.as_tensor(a), torch.as_tensor(b))
    ref = a.astype(np.float64) @ b.astype(np.float64)
    assert np.max(np.abs(out.numpy() - ref)) \
        <= 1e-5 * 128 * np.abs(a).max() * np.abs(b).max()


def test_gather_indices_are_the_probes():
    rows, nidx = probes.ROWS, probes.NIDX
    idx = probes.gather_indices(rows, nidx)
    ref = np.random.default_rng(0).integers(0, rows // 8, nidx)
    assert idx.dtype == np.int32 and np.array_equal(idx, ref)


@pytest.mark.parametrize("rows,c,per", [(1024, 16, 32), (512, 8, 4)])
def test_gather_plain_matches_numpy(rows, c, per):
    """Group g sums the 8-row packed blocks pool[8 r : 8 r + 8] at the
    starts r = idx[g*per + k], k < per."""
    rng = np.random.default_rng(2)
    pool = rng.standard_normal((rows, c)).astype(np.float32)
    nidx = 8 * per
    idx = probes.gather_indices(rows, nidx)
    out = probes.probe_gather(torch.as_tensor(pool.reshape(rows // 8, 8 * c)),
                              torch.as_tensor(idx), per).numpy()
    G = nidx // per
    ref = np.zeros((G, 8, c))
    for g in range(G):
        for k in range(per):
            r = idx[g * per + k]
            ref[g] += pool[8 * r:8 * r + 8].astype(np.float64)
    assert out.shape == (G, 8, c)
    assert np.max(np.abs(out - ref)) <= 1e-5 * np.abs(ref).max()


def test_gather_last_group_is_the_tpu_output():
    """The TPU kernel keeps one accumulator, so its output is the last
    group's sum: PER rows of ones at the probe's pool of ones."""
    rows, c = 4096, 128
    pool8 = torch.ones((rows // 8, 8 * c))
    idx = torch.as_tensor(probes.gather_indices(rows, probes.NIDX))
    out = probes.probe_gather(pool8, idx)
    assert out.shape == (probes.NIDX // probes.PER, 8, c)
    assert torch.equal(out[-1], torch.full((8, c), float(probes.PER)))


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros((8, 128))
    counts = [f.launches for f in (kernels.probe_copy_cuda,
                                   kernels.probe_matmul_cuda,
                                   kernels.gather_sum_cuda)]
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.probe_copy_cuda(x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.probe_matmul_cuda(x, x.T)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.probe_gather_cuda(x, torch.zeros(4, dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.gather_sum_cuda(x, torch.zeros(4, dtype=torch.int32), 4)
    assert counts == [f.launches for f in (kernels.probe_copy_cuda,
                                           kernels.probe_matmul_cuda,
                                           kernels.gather_sum_cuda)]


@pytest.fixture(scope="module")
def ladder_plan():
    """laplace_3d(8), ND, f32, supernodal: its segments' ladder tables
    (``gsc``), which ``splan._build_gather_tables`` built, hold both
    width classes."""
    from parsy_bench_tpu_torch import CholeskySolver, SolverConfig
    from parsy_bench_tpu_torch.core import generate
    return CholeskySolver(generate.laplace_3d(8), SolverConfig(
        ordering="nd", dtype="float32", tier="supernodal"),
        device="cpu").plan


@pytest.mark.parametrize("c", [32, 128])
def test_gather_sum_plain_is_the_ladder_sum(ladder_plan, c):
    """At every ladder sum of the plan's class c: ``gather_sum_plain(call,
    gi[t].flatten(), m)`` is the executor's ``call[gi[t]].sum(dim=1)``
    bit for bit, on a call buffer whose row 0 is the zero row, and within
    1e-5 of the largest |sum| of a float64 numpy sum."""
    ci = ladder_plan.classes.index(c)
    rng = np.random.default_rng(c)
    n = 0
    for seg in ladder_plan.segments:
        ent = (seg.gsc or [None] * (ci + 1))[ci]
        if ent is None:
            continue
        call = rng.standard_normal((ent["ntot"] + 1, c)).astype(np.float32)
        call[0] = 0.0
        tcall = torch.as_tensor(call)
        for m, g in zip(ent["ladder"], ent["gidx"]):
            assert g.dtype == np.int32 and g.shape[2] == m
            for t in range(seg.nsteps):
                gi = torch.as_tensor(g[t])
                ref = tcall[gi].sum(dim=1)
                out = probes.gather_sum_plain(tcall, gi.flatten(), m)
                assert torch.equal(out, ref)
                ref64 = call[g[t]].astype(np.float64).sum(1)
                assert np.abs(out.numpy() - ref64).max() \
                    <= 1e-5 * max(np.abs(ref64).max(), 1e-30)
                n += 1
    assert n > 0


def test_gather_bytes_counts_distinct_rows():
    """Each distinct row once, the indices, the sums: 3 distinct rows of
    w = 8 among 6 indices in 2 groups."""
    idx = np.array([5, 5, 1, 0, 1, 5], dtype=np.int32)
    assert probes.gather_bytes(idx, 3, 8) == 3 * 8 * 4 + 6 * 4 + 2 * 8 * 4


def test_import_builds_nothing_and_entry_point_needs_a_card():
    """Importing the probes and the kernel module loads no library and
    needs no nvcc; the entry point exits 2 without CUDA."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import parsy_bench_tpu_torch.ops.build as b\n"
        "def refuse():\n"
        "    raise AssertionError('build() called')\n"
        "b.build = refuse\n"
        "from parsy_bench_tpu_torch import probes\n"
        "from parsy_bench_tpu_torch.ops import kernels\n"
        "import torch\n"
        "probes.probe_copy(torch.zeros(3))\n"
        "assert kernels._lib is None\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    out = subprocess.run([sys.executable, "-m",
                          "parsy_bench_tpu_torch.probes"], cwd=_REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 2 and out.stdout == "", out.stderr
    assert "is_available() is False" in out.stderr
