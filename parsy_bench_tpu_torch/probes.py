"""Toolchain and gather probes on the card: P1 copy, P2 matmul, P3 gather.

Counterpart of ``scripts/pallas_probe.py`` (a tile copy and a 128 x 128
product, to show that hand-written kernels build and run) and
``scripts/pallas_gather_probe.py`` (the 8-row packed gather-and-sum that
bounds the update gathers).  The kernels are in ``csrc/probes.cu``, bound
in ``ops/kernels.py``; each stands beside its plain PyTorch version here.

    python -m parsy_bench_tpu_torch.probes

builds the kernels, holds each against its plain version, times both with
CUDA events and prints one JSON line per variant.  It needs a CUDA card
and exits 2 without one.
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch

from parsy_bench_tpu_torch.ops import kernels

#: the TPU gather probe's shapes: a (rows, c) f32 pool (32 MB, within the
#: H100's 50 MB L2), nidx packed 8-row starts, PER of them summed per group
ROWS, WIDTH, NIDX, PER = 1 << 16, 128, 1 << 12, 32
#: pool rows of the second gather run: 256 MB, so its rate is HBM's
HBM_ROWS = 1 << 19


# ---------------------------------------------------------- plain versions
def copy_plain(x):
    return x.clone()


def matmul_plain(a, b):
    return torch.matmul(a, b)


def gather_plain(pool8, idx, per):
    """pool8 (rows8, 8c), idx (nidx,) -> (nidx / per, 8, c): group g sums
    the packed rows pool8[idx[g*per + k]] over k < per (the TPU probe's
    ``xla_take``, with every group kept)."""
    G = idx.numel() // per
    return pool8[idx.long()].view(G, per, 8, pool8.shape[1] // 8).sum(1)


# ----------------------------------------------------------- dispatchers
def _route(x, kernel, plain, *args):
    if x.device.type == "cuda":
        return kernel(*args)
    if x.device.type == "cpu":
        return plain(*args)
    raise ValueError(f"unsupported device {x.device}")


def probe_copy(x):
    """P1: the kernel for a CUDA tensor, ``copy_plain`` for a CPU one."""
    return _route(x, kernels.probe_copy_cuda, copy_plain, x)


def probe_matmul(a, b):
    """P2: the kernel for CUDA tensors, ``matmul_plain`` for CPU ones."""
    return _route(a, kernels.probe_matmul_cuda, matmul_plain, a, b)


def probe_gather(pool8, idx, per=PER):
    """P3: the kernel for CUDA tensors, ``gather_plain`` for CPU ones."""
    return _route(pool8, kernels.probe_gather_cuda, gather_plain, pool8,
                  idx, per)


def gather_indices(rows, nidx, seed=0):
    """The probe's packed-row starts: uniform in [0, rows / 8)."""
    return (np.random.default_rng(seed).integers(0, rows // 8, nidx)
            .astype(np.int32))


# ---------------------------------------------------------------- timing
#: device clock cycles of the sleep queued ahead of each timed call: about
#: 100 µs at the H100's ~2 GHz, more than the host takes to enqueue a call
#: of a kernel wrapper
_SLEEP_CYCLES = 200_000


def cuda_ms(fn, reps, warm=2):
    """Mean device milliseconds per call over ``reps`` back-to-back calls,
    CUDA events.  A device-side sleep queued first lets the host enqueue
    the calls before the first one runs, so the host's own time per call
    (the wrapper, the launch) is not timed where it is shorter than the
    call's device time plus 100 µs."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(reps * _SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_cold(fn, reps, flush):
    """Mean milliseconds per call, each call timed alone with CUDA events
    after ``flush`` (a write larger than L2) evicted the cache."""
    fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


# ----------------------------------------------------------------- probes
def _copy_record(dev):
    x = torch.arange(1024, dtype=torch.float32, device=dev).reshape(8, 128)
    y = probe_copy(x)
    if not torch.equal(y, copy_plain(x)):
        raise AssertionError("P1 copy is not bit-equal to its input")
    return dict(variant="copy", shape=[8, 128], max_abs_err=0.0,
                ms=cuda_ms(lambda: probe_copy(x), 50),
                plain_ms=cuda_ms(lambda: copy_plain(x), 50))


def _matmul_record(dev):
    n = 128
    ones = torch.ones((n, n), dtype=torch.float32, device=dev)
    two = 2.0 * torch.eye(n, dtype=torch.float32, device=dev)
    if not torch.equal(probe_matmul(ones, two), torch.full_like(ones, 2.0)):
        raise AssertionError("P2 matmul: ones @ 2I is not exactly 2")
    rng = np.random.default_rng(1)
    a = torch.as_tensor(rng.standard_normal((n, n)).astype(np.float32),
                        device=dev)
    b = torch.as_tensor(rng.standard_normal((n, n)).astype(np.float32),
                        device=dev)
    err = float((probe_matmul(a, b) - matmul_plain(a, b)).abs().max())
    bar = 1e-5 * n * float(a.abs().max()) * float(b.abs().max())
    if not err <= bar:
        raise AssertionError(f"P2 matmul: |d| {err:.3e} > {bar:.3e}")
    return dict(variant="matmul", shape=[n, n, n], max_abs_err=err, bar=bar,
                ms=cuda_ms(lambda: probe_matmul(a, b), 50),
                plain_ms=cuda_ms(lambda: matmul_plain(a, b), 50))


def _gather_record(dev, rows, cold):
    gen = torch.Generator(device=dev).manual_seed(rows)
    pool8 = torch.randn((rows // 8, 8 * WIDTH), generator=gen, device=dev,
                        dtype=torch.float32)
    idx = torch.as_tensor(gather_indices(rows, NIDX), device=dev)
    out = probe_gather(pool8, idx, PER)
    ref = gather_plain(pool8, idx, PER)
    err = float((out - ref).abs().max())
    bar = 1e-5 * float(ref.abs().max())
    if not err <= bar:
        raise AssertionError(f"P3 gather at {rows} rows: |d| {err:.3e} > "
                             f"{bar:.3e}")
    if cold:
        # 128 MB written between calls evicts the 50 MB L2
        flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
        ms = cuda_ms_cold(lambda: probe_gather(pool8, idx, PER), 20, flush)
        plain_ms = cuda_ms_cold(lambda: gather_plain(pool8, idx, PER), 20,
                                flush)
    else:
        ms = cuda_ms(lambda: probe_gather(pool8, idx, PER), 20)
        plain_ms = cuda_ms(lambda: gather_plain(pool8, idx, PER), 20)
    nbytes = NIDX * 8 * WIDTH * 4
    return dict(variant="gather", pool_mb=rows * WIDTH * 4 / 2**20,
                l2="cold" if cold else "warm", nidx=NIDX, per=PER,
                max_abs_err=err, bar=bar, ms=ms, plain_ms=plain_ms,
                gb_per_s=nbytes / ms / 1e6,
                plain_gb_per_s=nbytes / plain_ms / 1e6,
                rows_per_s=NIDX * 8 / ms * 1e3,
                plain_rows_per_s=NIDX * 8 / plain_ms * 1e3)


def run(device="cuda") -> list:
    """Every probe on the card, each held against its plain version and
    timed with it; raises on a disagreement.  Returns one record per
    variant (P3 twice: the probe's 32 MB pool with a warm L2, and a 256 MB
    pool with L2 flushed before every call)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("the probes run on a CUDA device")
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmuls are on: the plain P2 would round "
                           "its inputs to TF32")
    recs = [_copy_record(dev), _matmul_record(dev),
            _gather_record(dev, ROWS, cold=False),
            _gather_record(dev, HBM_ROWS, cold=True)]
    name = torch.cuda.get_device_name(dev)
    for r in recs:
        r["device"] = name
    return recs


def main() -> int:
    if not torch.cuda.is_available():
        print("probes: torch.cuda.is_available() is False; the probes need "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    for rec in run():
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
