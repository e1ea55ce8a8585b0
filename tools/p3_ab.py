#!/usr/bin/env python3
"""P3, the gather-and-sum, of another checkout against this one's, on the
card, in one process:

    python3 tools/p3_ab.py OTHER_CHECKOUT

builds OTHER_CHECKOUT's kernel library with its own ``ops/build.py`` and
this checkout's, holds both kernels against the plain version, and times
them in turns with ``chip_smoke.py`` phase 10's methods: CUDA events
(``probes.cuda_ms`` with L2 warm, ``probes.cuda_ms_cold`` after the read
flush or after the call buffer's write; the median of 6 samples each) and
the kernel time from torch.profiler (``chip_smoke._profiled_ms``).  The
shapes: the TPU probe's two pools, every (class, ladder m) shape of the
main path (``laplace_3d(48)``, ND, f32, supernodal; the step with the
largest R), and one pass over a factorize's ladder sums (kernel time
only).  Prints the card line and one JSON line per shape, each variant
as [event ms, kernel ms].  The other checkout's P3 is called through
``pbt_gather_sum_f32`` or, where its library lacks that symbol,
``pbt_probe_gather_f32`` (the earlier name, the same arguments).  Needs a
CUDA card; an earlier checkout can be unpacked for it with
``git archive <commit> parsy_bench_tpu_torch | tar -x -C <dir>``.
"""
from __future__ import annotations

import ctypes
import functools
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.modules["jax"] = None

#: kernel names as torch.profiler shows them: this checkout's and the
#: earlier one's
NAMES = ("gather_sum_kernel", "gather_kernel")


def _other_kernel(path):
    spec = importlib.util.spec_from_file_location(
        "other_build", os.path.join(path, "parsy_bench_tpu_torch", "ops",
                                    "build.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lib = ctypes.CDLL(mod.build())
    fn = getattr(lib, "pbt_gather_sum_f32", None) or lib.pbt_probe_gather_f32
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, I, I, I, I, P]
    fn.restype = I
    return fn


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from parsy_bench_tpu_torch import CholeskySolver, SolverConfig, probes
    from parsy_bench_tpu_torch.core import generate
    from parsy_bench_tpu_torch.ops import kernels

    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    other = _other_kernel(sys.argv[1])
    kernels._load()
    print(cs._card(), flush=True)

    def variants(pool, idx, per):
        G, (rows, w) = idx.numel() // per, pool.shape

        def theirs():
            out = torch.empty((G, w), device="cuda")
            err = other(pool.data_ptr(), idx.data_ptr(), out.data_ptr(),
                        rows, w, G, per,
                        torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"other checkout's P3: CUDA error {err}")
            return out
        return {"this": lambda: kernels.gather_sum_cuda(pool, idx, per),
                "other": theirs}

    def measure(label, pool, idx, per, flush, cold=True):
        fns = variants(pool, idx, per)
        ref = probes.gather_sum_plain(pool, idx, per)
        for name, fn in fns.items():
            err = float((fn() - ref).abs().max())
            if not err <= 1e-5 * float(ref.abs().max()):
                raise AssertionError(f"{label}: {name} |d| {err:.3e}")
        pairs = cs._interleaved(
            fns["this"], fns["other"],
            (lambda fn: probes.cuda_ms_cold(fn, 5, flush)) if cold
            else (lambda fn: probes.cuda_ms(fn, 20)), pairs=6)
        rec = {name: [pairs[key]["median"],
                      cs._profiled_ms(torch, fns[name], flush, NAMES)[0]]
               for name, key in (("this", "kernel"), ("other", "other"))}
        rec["this_faster_in"] = pairs["kernel_faster_in"]
        print(label, json.dumps(rec), flush=True)

    for rows, cold in ((probes.ROWS, False), (probes.HBM_ROWS, True)):
        pool8 = torch.randn((rows // 8, 8 * probes.WIDTH), device="cuda",
                            generator=torch.Generator(device="cuda")
                            .manual_seed(rows))
        idx = torch.as_tensor(probes.gather_indices(rows, probes.NIDX),
                              device="cuda")
        measure(f"probe {'cold' if cold else 'warm'}", pool8, idx,
                probes.PER, probes.l2_flush("cuda") if cold
                else (lambda: None), cold)
        del pool8

    plan = CholeskySolver(generate.laplace_3d(48), SolverConfig(
        ordering="nd", dtype="float32", tier="supernodal")).plan
    sums, ntot, pick = cs._ladder_tables(np, plan)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def table(k, t, ci, li):
        return torch.as_tensor(plan.segments[k].gsc[ci]["gidx"][li][t],
                               device="cuda").reshape(-1)

    for (c, m), (k, t, ci, li) in sorted(pick.items()):
        call = torch.randn((ntot[k, ci] + 1, c), generator=gen,
                           device="cuda")
        call[0] = 0.0
        src = call.clone()
        measure(f"ladder c={c} m={m}", call, table(k, t, ci, li), m,
                functools.partial(torch.mul, src, 1.0, out=call))
    calls = {ci: torch.randn((max(n for (_, cj), n in ntot.items()
                                  if cj == ci) + 1, plan.classes[ci]),
                             generator=gen, device="cuda")
             for ci in {ci for _, ci in ntot}}
    tables = {s: table(*s) for s in sums}

    def one_pass(name):
        for (k, t, ci, li) in sums:
            variants(calls[ci][:ntot[k, ci] + 1], tables[k, t, ci, li],
                     plan.segments[k].gsc[ci]["ladder"][li])[name]()

    print("pass", json.dumps({
        name: cs._profiled_ms(torch, functools.partial(one_pass, name),
                              lambda: None, NAMES, reps=1,
                              expect=len(sums))[0]
        for name in ("this", "other")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
