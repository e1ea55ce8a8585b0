"""Toolchain and gather probes on the card: P1 copy, P2 matmul, P3 gather.

Counterpart of ``scripts/pallas_probe.py`` (a tile copy and a 128 x 128
product, to show that hand-written kernels build and run) and
``scripts/pallas_gather_probe.py`` (the 8-row packed gather-and-sum that
bounds the update gathers).  The kernels are in ``csrc/probes.cu``, bound
in ``ops/kernels.py``; each stands beside its plain PyTorch version here.
P3 is a general gather-and-sum (``gather_sum_plain``; the kernel
``kernels.gather_sum_cuda``) over rows of any width that is a multiple of
4 floats, which also computes the executor's ladder sums;
``probe_gather`` is the TPU probe's packed view of it.

    python -m parsy_bench_tpu_torch.probes

builds the kernels, holds each against its plain version, times both with
CUDA events and prints one JSON line per variant.  It needs a CUDA card
and exits 2 without one.
"""
from __future__ import annotations

import json
import statistics
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


def matmul_plain(a, b, trans_b=False):
    """a @ b, or a @ b^T with ``trans_b``: 2-D, or batched over a leading
    dimension (``torch.matmul``, which is ``bmm`` there)."""
    return torch.matmul(a, b.transpose(-2, -1) if trans_b else b)


#: the entrywise bar of ``matmul_error``: 2^-16 of sum_k |a_ik b_kj|.  A
#: single TF32 pass (operands cut to 11 significant bits, about 2^-11 per
#: product) exceeds it; 3xTF32 (about 2^-21 per product) and an f32
#: product (2^-24 per product, plus the f32 sum) stay well under it
MATMUL_REL_BAR = 2.0 ** -16


def matmul_error(out, a, b, trans_b=False):
    """How far a product ``out`` of a @ op(b) lies from the float64
    product: (max |out - ref|, the probe's bar 1e-5 K max|a| max|b|, the
    largest |out - ref| / sum_k |a_ik b_kj| over the entries).  A caller
    holds the second against the first and the third against
    ``MATMUL_REL_BAR``; an entry whose |a| @ |b| is 0 must be exactly 0."""
    a64, b64 = a.double(), b.double()
    ref = matmul_plain(a64, b64, trans_b)
    mag = matmul_plain(a64.abs(), b64.abs(), trans_b)
    d = (out.double() - ref).abs()
    K = a.shape[-1]
    amax = float(a.abs().max()) if a.numel() else 0.0
    bmax = float(b.abs().max()) if b.numel() else 0.0
    rel = d / mag.clamp_min(torch.finfo(torch.float64).tiny)
    return (float(d.max()) if d.numel() else 0.0, 1e-5 * K * amax * bmax,
            float(rel.max()) if rel.numel() else 0.0)


def gather_sum_plain(pool, idx, per):
    """pool (rows, w), idx (G * per,) -> (G, w): group g sums the rows
    pool[idx[g*per + k]] over k < per (the executor's ladder sum
    ``call[gi[t]].sum(1)`` with idx = ``gi[t].flatten()``)."""
    G = idx.numel() // per
    return pool[idx.long()].view(G, per, pool.shape[1]).sum(1)


def gather_plain(pool8, idx, per):
    """pool8 (rows8, 8c), idx (nidx,) -> (nidx / per, 8, c): group g sums
    the packed rows pool8[idx[g*per + k]] over k < per (the TPU probe's
    ``xla_take``, with every group kept)."""
    out = gather_sum_plain(pool8, idx, per)
    return out.view(out.shape[0], 8, pool8.shape[1] // 8)


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


def probe_matmul(a, b, trans_b=False):
    """P2: the kernel for CUDA tensors, ``matmul_plain`` for CPU ones."""
    return _route(a, kernels.probe_matmul_cuda, matmul_plain, a, b, trans_b)


def probe_gather(pool8, idx, per=PER):
    """P3 at the TPU probe's layout: the kernel for CUDA tensors,
    ``gather_plain`` for CPU ones."""
    return _route(pool8, kernels.probe_gather_cuda, gather_plain, pool8,
                  idx, per)


def gather_indices(rows, nidx, seed=0):
    """The probe's packed-row starts: uniform in [0, rows / 8)."""
    return (np.random.default_rng(seed).integers(0, rows // 8, nidx)
            .astype(np.int32))


def gather_bytes(idx, per, w, itemsize=4):
    """Bytes a gather-and-sum must move, from its own indices: each
    distinct row read once, the indices, and the (G, w) sums written."""
    idx = np.asarray(idx)
    return (len(np.unique(idx)) * w * itemsize + idx.size * 4
            + idx.size // per * w * itemsize)


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


def cuda_ms_cold(fn, reps, flush, settle=True):
    """Median milliseconds of ``reps`` calls, each timed alone with CUDA
    events after ``flush()`` evicted L2 (``l2_flush``).  With ``settle``
    a device sleep of about 100 µs (it touches no memory) follows the
    flush, so the host has enqueued the call before its start event is
    reached.  On the H100 single cold calls of P3 read 0.023-0.070 ms
    without the sleep and 0.015 ms with it (after a write flush); with
    it, a call now and then still caught a host stall inside its window
    (0.035-0.065 ms; chip_smoke.py phase 10's flush study), so the median
    and not the mean is returned."""
    fn()
    times = []
    for _ in range(reps):
        flush()
        if settle:
            torch.cuda._sleep(_SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


#: bytes the L2 flush moves: 128 MB, over twice the H100's 50 MB L2
FLUSH_BYTES = 128 * 2**20
#: how the cold runs evict L2 (``l2_flush``): on the H100 a write flush
#: added 0.0023 ms of write-backs to P3's cold kernel time (0.0111 against
#: 0.0088 ms), time that belongs to the flush, not to the call
COLD_FLUSH = "read"


def l2_flush(device, how=COLD_FLUSH):
    """A call that evicts L2 before a cold call: ``"read"`` sums a 128 MB
    buffer, which leaves L2 holding clean lines; ``"write"`` zeroes it,
    which leaves it holding dirty lines, whose write-backs then fall
    inside the next call as it evicts them."""
    buf = torch.zeros(FLUSH_BYTES // 4, dtype=torch.float32, device=device)
    if how == "read":
        return lambda: buf.sum()
    if how == "write":
        return buf.zero_
    raise ValueError(f"unknown flush {how!r}")


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
    err, bar, rel = matmul_error(probe_matmul(a, b), a, b)
    if not (err <= bar and rel <= MATMUL_REL_BAR):
        raise AssertionError(f"P2 matmul: |d| {err:.3e} (bar {bar:.3e}), "
                             f"{rel:.3e} of sum |a b| (bar "
                             f"{MATMUL_REL_BAR:.3e}) against float64")
    plain_err = matmul_error(matmul_plain(a, b), a, b)[0]
    return dict(variant="matmul", shape=[n, n, n], max_abs_err=err, bar=bar,
                max_rel_err=rel, plain_max_abs_err=plain_err,
                ms=cuda_ms(lambda: probe_matmul(a, b), 50),
                plain_ms=cuda_ms(lambda: matmul_plain(a, b), 50))


def _gather_record(dev, rows, cold):
    gen = torch.Generator(device=dev).manual_seed(rows)
    pool8 = torch.randn((rows // 8, 8 * WIDTH), generator=gen, device=dev,
                        dtype=torch.float32)
    idx_np = gather_indices(rows, NIDX)
    idx = torch.as_tensor(idx_np, device=dev)
    out = probe_gather(pool8, idx, PER)
    ref = gather_plain(pool8, idx, PER)
    err = float((out - ref).abs().max())
    bar = 1e-5 * float(ref.abs().max())
    if not err <= bar:
        raise AssertionError(f"P3 gather at {rows} rows: |d| {err:.3e} > "
                             f"{bar:.3e}")
    if cold:
        flush = l2_flush(dev)
        ms = cuda_ms_cold(lambda: probe_gather(pool8, idx, PER), 20, flush)
        plain_ms = cuda_ms_cold(lambda: gather_plain(pool8, idx, PER), 20,
                                flush)
    else:
        ms = cuda_ms(lambda: probe_gather(pool8, idx, PER), 20)
        plain_ms = cuda_ms(lambda: gather_plain(pool8, idx, PER), 20)
    nbytes = gather_bytes(idx_np, PER, 8 * WIDTH)
    return dict(variant="gather", pool_mb=rows * WIDTH * 4 / 2**20,
                l2="cold" if cold else "warm",
                flush=COLD_FLUSH if cold else None,
                nidx=NIDX, per=PER, distinct_rows=len(np.unique(idx_np)),
                bytes=nbytes, max_abs_err=err, bar=bar, ms=ms,
                plain_ms=plain_ms, gb_per_s=nbytes / ms / 1e6,
                plain_gb_per_s=nbytes / plain_ms / 1e6,
                rows_per_s=NIDX * 8 / ms * 1e3,
                plain_rows_per_s=NIDX * 8 / plain_ms * 1e3)


def run(device="cuda") -> list:
    """Every probe on the card, each held against its plain version and
    timed with it; raises on a disagreement.  Returns one record per
    variant (P3 twice: the probe's 32 MB pool with a warm L2, and a 256 MB
    pool with L2 flushed before every call).  A gather's ``bytes`` come
    from its own indices (``gather_bytes``)."""
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
