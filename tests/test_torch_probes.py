"""The probes' plain versions (``parsy_bench_tpu_torch/probes.py``) against
numpy restatements of the TPU probes' arithmetic (scripts/pallas_probe.py,
scripts/pallas_gather_probe.py), and the probe entry point without a card.

The JAX probe kernels use TPU memory spaces and run only on a TPU; the
product's kernel body, ``jnp.dot(a, b, preferred_element_type=float32)``
(scripts/pallas_probe.py), runs here on the CPU at HIGHEST precision. The
CUDA kernels run only on the card, where ``chip_smoke.py`` and
``python -m parsy_bench_tpu_torch.probes`` hold them against these plain
versions.
"""
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
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


def _tpu_body(a, b):
    """The TPU probe kernel's body, ``jnp.dot`` with f32 accumulation, at
    HIGHEST precision (no bf16 passes), batched by ``vmap`` over a
    leading dimension."""
    dot = functools.partial(jnp.dot, precision=jax.lax.Precision.HIGHEST,
                            preferred_element_type=jnp.float32)
    if a.ndim == 3:
        dot = jax.vmap(dot)
    return np.asarray(dot(a, b))


@pytest.mark.parametrize("L,M,N,K,trans_b",
                         [(0, 37, 45, 21, False), (5, 20, 24, 36, False),
                          (5, 20, 24, 36, True), (3, 16, 16, 32, True),
                          (2, 64, 48, 128, True), (1, 256, 136, 128, True),
                          (2, 64, 128, 136, True)],
                         ids=["2d-ragged", "batched", "batched-bt",
                              "update-16-32-16", "update-64-128-48",
                              "update-256-128-136", "K136"])
def test_matmul_plain_forms(L, M, N, K, trans_b):
    """``matmul_plain`` (and ``probe_matmul`` on CPU tensors) in 2-D and
    batched forms, with B as (K, N) or (N, K), against a float64 numpy
    product and the TPU kernel's body on the same seeded inputs: both
    within 1e-5 K max|a| max|b| (the probe's bar) of float64, and within
    2^-16 of sum_k |a_ik b_kj| entrywise (``probes.MATMUL_REL_BAR``)."""
    rng = np.random.default_rng(L * 1000 + M + N + K)
    lead = (L,) if L else ()
    a = rng.standard_normal(lead + (M, K)).astype(np.float32)
    b = rng.standard_normal(lead + ((N, K) if trans_b else (K, N))) \
        .astype(np.float32)
    bk = np.swapaxes(b, -1, -2) if trans_b else b
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    out = probes.matmul_plain(ta, tb, trans_b)
    assert torch.equal(probes.probe_matmul(ta, tb, trans_b), out)
    ref = np.matmul(a.astype(np.float64), bk.astype(np.float64))
    jax_out = _tpu_body(a, np.ascontiguousarray(bk))
    bar = 1e-5 * K * np.abs(a).max() * np.abs(b).max()
    rel_den = np.matmul(np.abs(a).astype(np.float64),
                        np.abs(bk).astype(np.float64))
    for got in (out.numpy(), jax_out):
        assert got.shape == ref.shape and got.dtype == np.float32
        assert np.abs(got - ref).max() <= bar
        assert (np.abs(got - ref) / rel_den).max() <= probes.MATMUL_REL_BAR
    assert np.abs(out.numpy() - jax_out).max() <= bar
    err, pbar, rel = probes.matmul_error(out, ta, tb, trans_b)
    assert err <= pbar and rel <= probes.MATMUL_REL_BAR
    assert np.isclose(pbar, bar)


def test_matmul_error_refuses_a_single_tf32_pass():
    """Operands cut to TF32 (the 13 low bits rounded away) give a product
    that ``matmul_error``'s entrywise bar refuses; the f32 product passes."""
    rng = np.random.default_rng(4)
    a = torch.as_tensor(rng.standard_normal((64, 128)).astype(np.float32))
    b = torch.as_tensor(rng.standard_normal((48, 128)).astype(np.float32))

    def tf32(x):
        bits = x.view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    rel_f32 = probes.matmul_error(probes.matmul_plain(a, b, True), a, b,
                                  True)[2]
    rel_tf32 = probes.matmul_error(
        probes.matmul_plain(tf32(a), tf32(b), True), a, b, True)[2]
    assert rel_f32 <= probes.MATMUL_REL_BAR < rel_tf32


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
    x3 = torch.zeros((2, 8, 128))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.probe_matmul_cuda(x3, x3.transpose(1, 2).contiguous())
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.probe_matmul_cuda(x3, x3, trans_b=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.probe_gather_cuda(x, torch.zeros(4, dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.gather_sum_cuda(x, torch.zeros(4, dtype=torch.int32), 4)
    assert counts == [f.launches for f in (kernels.probe_copy_cuda,
                                           kernels.probe_matmul_cuda,
                                           kernels.gather_sum_cuda)]


@pytest.mark.parametrize("a,b,trans_b", [
    ((8, 16), (17, 4), False),            # K differs
    ((8, 16), (4, 17), True),             # K differs, B as (N, K)
    ((2, 8, 16), (16, 4), False),         # batched A, 2-D B
    ((2, 8, 16), (3, 16, 4), False),      # batch lengths differ
    ((2, 8, 16), (2, 4, 16), False),      # (N, K) B without trans_b
    ((2, 2, 8, 16), (2, 2, 16, 4), False),  # two batch dimensions
    ((16,), (16, 4), False)],             # 1-D A
    ids=["K", "K-bt", "dims", "L", "bt-missing", "4d", "1d"])
def test_matmul_wrapper_refuses_shapes(a, b, trans_b):
    """Mis-shaped operands are refused before any device or launch, and
    the count does not move."""
    n = kernels.probe_matmul_cuda.launches
    with pytest.raises(ValueError, match="expected"):
        kernels.probe_matmul_cuda(torch.zeros(a), torch.zeros(b), trans_b)
    assert kernels.probe_matmul_cuda.launches == n


@pytest.mark.parametrize("L,M,N,K", [(1, 2**16, 8, 2**15),
                                     (2**16, 2**8, 8, 2**7),
                                     (2**12, 8, 2**10, 2**9)],
                         ids=["MK", "MN", "NK"])
def test_matmul_wrapper_refuses_int32_overflow(L, M, N, K):
    """L M K, L N K or L M N at 2^31 or more is refused (meta tensors:
    nothing is allocated); the count does not move."""
    n = kernels.probe_matmul_cuda.launches
    a = torch.empty((L, M, K), device="meta")
    b = torch.empty((L, N, K), device="meta")
    with pytest.raises(ValueError, match="int32 offsets"):
        kernels.probe_matmul_cuda(a, b, trans_b=True)
    assert kernels.probe_matmul_cuda.launches == n


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
