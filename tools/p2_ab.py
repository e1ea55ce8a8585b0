#!/usr/bin/env python3
"""P2's inner loop on the card: this checkout's 3xTF32 tensor-core product
against an FFMA register-tile variant of the same kernel, in one process:

    python3 tools/p2_ab.py

The variant is made from this checkout's ``csrc/probes.cu`` by swapping
the small-tile kernel's compute loop and its store for an FFMA loop on
the CUDA cores (lane (r, q) of a warp holds rows 4r..4r+3 of the warp's
16-row strip at the columns q + 8j, 16-byte shared-memory loads of four
k at a time) and turning off the route to the 64-row wgmma kernel, so
that every product runs the FFMA loop; the staging (the whole depth at
once), the launch shape and the dependent launch stay as they are.  It is compiled with the package's nvcc flags
into a git-ignored directory beside the package's own build.  Both are
held against a float64 product (``probes.matmul_error``: the probe's bar
and the entrywise bar) and timed in turns with ``chip_smoke.py`` phase
10's methods: CUDA events (``probes.cuda_ms_cold`` with the operands
written before each call, the median of 10) and the kernel time from
torch.profiler (``chip_smoke._profiled_ms``).  The shapes: the TPU
probe's 128^3 and, on the main path's plan (``laplace_3d(48)``, ND, f32,
supernodal), both update products of every (c, Mc, K, Q) class at its
step with the most lanes; then one pass over every update product of a
factorize with each (kernel time only).  Prints the card line and one
JSON line per shape.  Needs a CUDA card.
"""
from __future__ import annotations

import ctypes
import functools
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.modules["jax"] = None

#: P2's compute loop and store in csrc/probes.cu (what the variant swaps)
COMPUTE = ("    if (live) {\n#pragma unroll 2\n"
           "      for (int kk = 0; kk < kp; kk += 8) {",
           "    __syncthreads();\n  }\n  launch_dependents();")
STORE = ("  const bool pair = s.N % 2 == 0;\n", "\n}\n\n// d (64 x NW")
#: the route to the 64-row wgmma kernel (the variant takes every product
#: through its FFMA loop)
ROUTE = "  if (trans_b && vec && M >= 64 && N >= 96 && K >= 64 && K <= kWgMaxK) {"

FFMA_COMPUTE = """    if (live) {
      // FFMA register tile: lane (r, q) = (lane / 8, lane % 8) holds rows
      // 4r .. 4r + 3 of the strip at the columns q + 8j
      const int r4 = threadIdx.x % 32 / 8 * 4;
      const int q = threadIdx.x % 8;
      for (int kk = 0; kk < kp; kk += 4) {
        float4 av[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          av[i] = *reinterpret_cast<const float4*>(Aw + (r4 + i) * s.sa
                                                   + kk);
        }
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const int n = wc0 + 8 * j + q;
          const float4 bv =
              TB ? *reinterpret_cast<const float4*>(Bw + n * s.sbs + kk)
                 : make_float4(Bw[kk * s.sbs + n], Bw[(kk + 1) * s.sbs + n],
                               Bw[(kk + 2) * s.sbs + n],
                               Bw[(kk + 3) * s.sbs + n]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[j][i] = fmaf(av[i].x, bv.x, acc[j][i]);
            acc[j][i] = fmaf(av[i].y, bv.y, acc[j][i]);
            acc[j][i] = fmaf(av[i].z, bv.z, acc[j][i]);
            acc[j][i] = fmaf(av[i].w, bv.w, acc[j][i]);
          }
        }
      }
    }
"""
FFMA_STORE = """  const int r4 = threadIdx.x % 32 / 8 * 4;
  const int q = threadIdx.x % 8;
#pragma unroll
  for (int j = 0; j < NI; ++j) {
    const int col = wc0 + 8 * j + q;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + r4 + i;
      if (row < s.M && col < ncols) {
        cl[static_cast<size_t>(row) * s.N + col] = acc[j][i];
      }
    }
  }"""


def _swap(src, marks, body):
    i = src.index(marks[0])
    return src[:i] + body + src[src.index(marks[1], i):]


def ffma_source(src: str) -> str:
    """``csrc/probes.cu`` with P2's inner loop and store on FFMA."""
    for m in COMPUTE + STORE + (ROUTE,):
        if m not in src:
            raise AssertionError(f"probes.cu no longer holds {m!r}")
    src = _swap(src, COMPUTE, FFMA_COMPUTE)
    src = _swap(src, STORE, FFMA_STORE)
    return src.replace(ROUTE, "  if (false) {")


def _build_variant():
    from parsy_bench_tpu_torch.ops import build
    out = os.path.join(build.BUILD_DIR, "p2_ab")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(build.CSRC, "probes.cu")) as f:
        src = ffma_source(f.read())
    cu = os.path.join(out, "probes_ffma.cu")
    with open(cu, "w") as f:
        f.write(src)
    so = os.path.join(out, "libp2_ffma.so")
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared",
                          "-o", so, cu], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on the FFMA variant:\n{res.stdout}"
                           f"\n{res.stderr}")
    lines = [ln for ln in (res.stdout + res.stderr).splitlines()
             if "matmul_kernel" in ln or "registers" in ln]
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = lib.pbt_matmul_f32
    fn.argtypes = [P, P, P, I, I, I, I, I, P]
    fn.restype = I
    return fn, lines


def main() -> int:
    import torch

    import chip_smoke as cs
    from parsy_bench_tpu_torch import CholeskySolver, SolverConfig, probes
    from parsy_bench_tpu_torch.core import generate
    from parsy_bench_tpu_torch.ops import build, kernels

    if not torch.cuda.is_available():
        print("p2_ab: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs._card())
    build.build()
    kernels._load()
    ffma_fn, ptxas = _build_variant()
    print("FFMA variant ptxas:", json.dumps(ptxas[-16:]))

    def ffma(a, b, trans_b=False):
        M, K = a.shape[-2:]
        L = a.shape[0] if a.dim() == 3 else 1
        N = b.shape[-2] if trans_b else b.shape[-1]
        out = torch.empty(a.shape[:-2] + (M, N), device=a.device)
        err = ffma_fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), L, M, N,
                      K, int(trans_b),
                      torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"FFMA variant: CUDA error {err}")
        return out

    variants = {"3xtf32": kernels.probe_matmul_cuda, "ffma": ffma}

    def record(x, y, trans_b, fill, **meta):
        rec = dict(meta)
        nbytes, flops = cs._product_work(
            *(x.shape[:2] if x.dim() == 3 else (1, x.shape[0])),
            y.shape[-2] if trans_b else y.shape[-1], x.shape[-1])
        rec["bound_3xtf32_ms"] = cs._tc_bound_ms(nbytes, flops)
        rec["bound_f32_ms"] = cs._bound(nbytes, flops)[0]
        for name, fn in variants.items():
            call = functools.partial(fn, x, y, trans_b)
            err, bar, rel = probes.matmul_error(call(), x, y, trans_b)
            if not (err <= bar and rel <= probes.MATMUL_REL_BAR):
                raise AssertionError(f"{name} at {meta}: |d| {err:.3e} "
                                     f"(rel {rel:.3e}), bar {bar:.3e}")
            rec[f"{name}_max_abs_err"] = err
        order = list(variants) + list(variants)[::-1]
        for name in order:
            call = functools.partial(variants[name], x, y, trans_b)
            ev = probes.cuda_ms_cold(call, 10, fill)
            pr = cs._profiled_ms(torch, call, fill, skip=(cs.FILL_NAME,),
                                 expect=2)[0]
            rec.setdefault(f"{name}_ms", []).append(pr)
            rec.setdefault(f"{name}_event_ms", []).append(ev)
        print("p2 ab", json.dumps(rec), flush=True)
        return rec

    gen = torch.Generator(device="cuda").manual_seed(0)
    pa, pb = (torch.randn((128, 128), generator=gen, device="cuda")
              for _ in range(2))
    sa, sb = pa.clone(), pb.clone()

    def fill_probe():
        torch.mul(sa, 1.0, out=pa)
        torch.mul(sb, 1.0, out=pb)
    record(pa, pb, False, fill_probe, shape="probe 128^3")

    solver = CholeskySolver(generate.laplace_3d(48), SolverConfig(
        ordering="nd", dtype="float32", tier="supernodal"))
    solver.factorize()
    plan, ex, pools = solver.plan, solver.executor, solver.lx
    steps, pick = cs._update_steps(plan, ex)
    for key, s in sorted(pick.items()):
        A, Braw, S = cs._update_operands(plan, ex, pools, s)
        Chat = torch.bmm(A, Braw.transpose(1, 2))
        for which, (x, y) in (("A B_raw^T", (A, Braw)),
                              ("Chat S^T", (Chat, S))):
            x, y = x.contiguous(), y.contiguous()
            sx, sy = x.clone(), y.clone()

            def fill(x=x, y=y, sx=sx, sy=sy):
                torch.mul(sx, 1.0, out=x)
                torch.mul(sy, 1.0, out=y)
            record(x, y, True, fill, c=key[0], Mc=key[1], K=key[2],
                   Q=key[3], product=which, L=int(x.shape[0]))

    srcs = [cs._update_operands(plan, ex, pools, s) for s in steps]

    def one_pass(fn):
        for A, Braw, S in srcs:
            fn(fn(A, Braw, True), S, True)
        torch.cuda.synchronize()
    passes = {}
    for name in list(variants) + list(variants)[::-1]:
        passes.setdefault(name, []).append(cs._profiled_ms(
            torch, functools.partial(one_pass, variants[name]),
            lambda: None, cs.P2_NAMES, reps=1, expect=2 * len(steps))[0])
    print("p2 ab pass", json.dumps(dict(products=2 * len(steps), **passes)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
