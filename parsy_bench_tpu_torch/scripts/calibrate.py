"""Card calibration: the port's counterpart of ``scripts/calibrate.py``.

    python -m parsy_bench_tpu_torch.scripts.calibrate [--quick]
        [--device cpu]

Measures, on the card unless ``--device cpu`` is given, the ceilings in
the units of ``utils/perfmodel.ChipModel``'s fields, with the JAX
script's shapes and seeds:

* dispatch floor (``dispatch_s``): ``x + 1`` on an 8-vector, eager and
  synchronized, not amortized;
* row gather rate (``gather_rows_per_s``): packed 8-row gathers of
  ``NIDX`` row groups (``idx = default_rng(0).integers(0, ROWS // 8,
  NIDX) * 8``) from a (``ROWS``, ``C``) pool, every gathered element
  summed;
* row scatter rate (``scatter_rows_per_s``): row scatter-adds
  (``index_add_``) of ones into the pool at ``idx`` and ``idx + 1``;
* stream bandwidth (``stream_bytes_per_s``): a ``W``-row window read,
  added to and written back at row offset ``i & 7``;
* batched-product rate and per-lane floor (``mxu_flops_per_s``,
  ``lane_s``): ``bmm`` of (P, m, k) against (P, 48, k)^T at (64, 256, 128)
  and (4096, 16, 128), the next input offset by the last output's sum,
  in full f32 (TF32 refused);
* dependent chain-op floor (``chain_op_s``): ``M = M * rsqrt(M[0, 0])``
  on a 16x16 block, 64 steps per repetition.

Each loop body runs ``reps`` times (10 with ``--quick``, else 50) inside
one program: the JAX script's ``fori_loop`` in one device program is here
the ``reps`` iterations captured once as one CUDA graph
(``ops/graphs.Program``) and replayed; on the CPU the same closure runs.
Each timing is the median of 5 synchronized calls after one untimed call
(on the card the warm-up and the capture).  Every body consumes all it
touches, as the JAX bodies do (the gather sums every gathered element,
the others sum their output, the products and the chain feed each step
from the last), and leaves that checksum in its output tensor
(``programs``).  The indices of both parities (gather rows ``idx // 8``
and ``idx // 8 + 1``, the latter clamped to the pool as JAX clamps an
out-of-range gather; scatter rows ``idx`` and ``idx + 1``) are on the
device before any capture, since nothing may copy from the host inside
one.

The JAX script's caveat, that XLA fuses and hoists loop bodies and so
reports fused upper bounds, does not carry over: each operation of a
captured body is its own node of the CUDA graph, launched as it was at
capture.  A chain step is two dependent nodes (``rsqrt``, then the
product); ``chain_op_s`` is per step, as in JAX.  The unfused operations
materialize what XLA may not (the gathered rows before their sum), so
these are the rates of the port's own operations, which the executor
runs.  Prints one JSON document with the JAX keys (``KEYS``) and
``card``; no ``ChipModel`` constant is written.  There is no fallback:
without CUDA the default device raises.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from parsy_bench_tpu_torch import bench
from parsy_bench_tpu_torch.ops import graphs
from parsy_bench_tpu_torch.ops.device import refuse_tf32, resolve_device

ROWS, C = 1 << 17, 128
NIDX = 1 << 13
W = 1 << 15
Q = 48
#: (P, m, k) of the products and the field each measures
PRODUCTS = ((64, 256, 128, "mxu"), (4096, 16, 128, "lane"))
CHAIN_N = 16
CHAIN_STEPS = 64   # chain steps per repetition
ITERS = 5
#: the JAX script's keys, in its order
KEYS = ("backend", "device", "dispatch_s", "gather_rows_per_s",
        "scatter_rows_per_s", "stream_bytes_per_s", "mxu_flops_per_s",
        "lane_s", "chain_op_s")


#: each key's field of ``utils/perfmodel.ChipModel`` (the dispatch floor
#: has none)
FIELDS = {"dispatch_s": None, "gather_rows_per_s": "gather_rows",
          "scatter_rows_per_s": "scatter_rows",
          "stream_bytes_per_s": "stream_bytes",
          "mxu_flops_per_s": "mxu_flops", "lane_s": "lane_s",
          "chain_op_s": "chain_op_s"}


def beside(measured: dict, chip) -> dict:
    """Each measured ceiling beside ``chip``'s field for it: key ->
    (field, fitted value, measured / fitted), the value and the ratio None
    where the field is missing or was fitted at no cost (a rate of inf, a
    fixed cost of 0)."""
    out = {}
    for key, field in FIELDS.items():
        v = None if field is None else float(getattr(chip, field))
        ok = v is not None and 0.0 < v < float("inf")
        out[key] = dict(field=field, fitted=v if ok else None,
                        ratio=measured[key] / v if ok else None)
    return out


def indices(rows=ROWS, nidx=NIDX) -> np.ndarray:
    """The JAX script's row indices: ``nidx`` multiples of 8 below
    ``rows``."""
    return np.random.default_rng(0).integers(0, rows // 8, nidx) * 8


def median_time(dev, fn, iters=ITERS) -> float:
    """Median host seconds of ``iters`` synchronized calls of ``fn``
    after one untimed call (the JAX script's ``_median_time``)."""
    fn()
    bench._sync(dev)
    ts = []
    for _ in range(iters):
        bench._sync(dev)
        t0 = time.perf_counter()
        fn()
        bench._sync(dev)
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def _program(name, fn, dev, pool):
    return graphs.Program(f"calibrate:{name}", fn, dev, pool).run


def programs(dev, reps, pool, idx, w=W, products=PRODUCTS,
             chain_n=CHAIN_N) -> dict:
    """name -> (run, output tensor) of each amortized body, ``reps``
    iterations per run, on ``pool`` (rows, c) and the row indices
    ``idx`` (multiples of 8): ``gather``, ``scatter``, ``stream``, one per
    product tag and ``chain``.  After a run each output holds its body's
    checksum: the gathered elements' sum over the iterations, the pool's
    sum after the scatters or the window updates (each run starts from
    ``pool``), the last product's sum times 1e-30, the chain's final
    M[0, 0]."""
    gp = graphs.graph_pool(dev)
    rows, c = pool.shape
    idx = torch.as_tensor(idx, device=dev, dtype=torch.int64)
    p8 = pool.view(-1, 8 * c)
    grow = (idx // 8, torch.clamp(idx // 8 + 1, max=rows // 8 - 1))
    srow = (idx, idx + 1)
    ones = torch.ones((idx.numel(), c), device=dev, dtype=pool.dtype)
    work = torch.empty_like(pool)
    out = {}

    def gather():
        acc = torch.zeros((), device=dev, dtype=pool.dtype)
        for i in range(reps):
            acc = acc + p8[grow[i & 1]].sum()
        o_gather.copy_(acc)

    def scatter():
        work.copy_(pool)
        for i in range(reps):
            work.index_add_(0, srow[i & 1], ones)
        o_scatter.copy_(work.sum())

    def stream():
        work.copy_(pool)
        for i in range(reps):
            work[i & 7:(i & 7) + w].add_(1.0)
        o_stream.copy_(work.sum())

    o_gather, o_scatter, o_stream = (
        torch.zeros((), device=dev, dtype=pool.dtype) for _ in range(3))
    out["gather"] = (_program("gather", gather, dev, gp), o_gather)
    out["scatter"] = (_program("scatter", scatter, dev, gp), o_scatter)
    out["stream"] = (_program("stream", stream, dev, gp), o_stream)
    for P, m, k, tag in products:
        A = torch.ones((P, m, k), device=dev, dtype=pool.dtype)
        Bt = torch.ones((P, Q, k), device=dev, dtype=pool.dtype).transpose(
            1, 2)
        o = torch.zeros((), device=dev, dtype=pool.dtype)

        def product(A=A, Bt=Bt, o=o):
            acc = torch.zeros((), device=dev, dtype=pool.dtype)
            for _ in range(reps):
                acc = torch.bmm(A + acc, Bt).sum() * 1e-30
            o.copy_(acc)
        out[tag] = (_program(tag, product, dev, gp), o)
    D = torch.eye(chain_n, device=dev, dtype=pool.dtype) * 4.0
    o_chain = torch.zeros((), device=dev, dtype=pool.dtype)

    def chain():
        M = D
        for _ in range(CHAIN_STEPS * reps):
            M = M * torch.rsqrt(M[0, 0])
        o_chain.copy_(M[0, 0])
    out["chain"] = (_program("chain", chain, dev, gp), o_chain)
    return out


def run(device="cuda", quick=False) -> dict:
    """The ceilings on ``device`` (the JAX keys, then ``card``) and each
    body's checksum (``checksums``, not printed)."""
    dev = resolve_device(device)
    refuse_tf32(dev)
    reps = 10 if quick else 50
    tiny = torch.zeros(8, device=dev)
    out = dict(backend=dev.type,
               device=(torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"))
    out["dispatch_s"] = median_time(dev, lambda: tiny + 1)
    pool = torch.ones((ROWS, C), device=dev)
    progs = programs(dev, reps, pool, indices())
    t = {name: median_time(dev, prog) for name, (prog, _) in progs.items()}
    out["gather_rows_per_s"] = NIDX * 8 * reps / t["gather"]
    out["scatter_rows_per_s"] = NIDX * reps / t["scatter"]
    out["stream_bytes_per_s"] = 2.0 * W * C * 4 * reps / t["stream"]
    for P, m, k, tag in PRODUCTS:
        per = t[tag] / reps
        if tag == "mxu":
            out["mxu_flops_per_s"] = 2.0 * P * m * Q * k / per
        else:
            out["lane_s"] = per / P
    out["chain_op_s"] = t["chain"] / (CHAIN_STEPS * reps)
    out["card"] = bench._card() if dev.type == "cuda" else "cpu"
    return dict(out, checksums={name: float(o) for name, (_, o)
                                in progs.items()})


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.device, args.quick)
    out.pop("checksums")
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
