"""k1_roofline: K1's share, in %, of its roofline in the traced
factorizes: the least time the card could take for the work the plan's
finalize buckets need, over the device time of the kernels that do it.

The work is counted per real lane at its logical width (each
``FinBucket``'s first ``cnt[t]`` lanes at step t, width ``w[t, lane]``),
not from K1's launches, so it reads the same whatever computes the
finalize's dense blocks:

* FLOPs: w^3 / 3 for the Cholesky and w^3 / 3 for the inverse of a lane;
* bytes: D's lower triangle read once, L and Linv written once, each
  w (w + 1) / 2 elements of the configuration's dtype.

The least time is the larger of FLOPs over the card's float32 peak and
bytes over its HBM bandwidth (``peaks.py``, at full power; the run's card
line gives its power limit).  The time is the device time of the
operations named in ``KERNELS`` inside the factorize spans."""
import numpy as np

from benchmark import peaks

#: K1's kernels as torch.profiler names them (csrc/chol_inverse.cu)
KERNELS = ("chol_inverse_warp_kernel", "chol_inverse_blocked_kernel")
_ELEM_BYTES = {"float32": 4, "float64": 8}


def work(plan, elem_bytes: int):
    """(FLOPs, bytes) of one factorize's finalize blocks."""
    flops = nbytes = 0.0
    for seg in plan.segments:
        for b in seg.fin:
            for t in range(seg.nsteps):
                w = np.asarray(b.w[t, :int(b.cnt[t])], dtype=np.float64)
                flops += float(np.sum(2.0 * w ** 3 / 3.0))
                nbytes += float(np.sum(3.0 * w * (w + 1) / 2.0)) * elem_bytes
    return flops, nbytes


def read(run):
    peak = peaks.PEAKS.get(run.device_kind)
    dtype = run.cell.config["solver"]["dtype"]
    if peak is None or run.trace is None or dtype != "float32":
        return None
    spans = run.trace.ops_in("factorize")
    k1 = [sum(e - s for name, s, e in ops
              if any(k in name for k in KERNELS)) for ops in spans]
    if not spans or not all(k1):
        return None
    k1_s = sum(k1) / len(k1) / 1e6
    flops, nbytes = work(run.system.solver.plan, _ELEM_BYTES[dtype])
    least = max(flops / peak["float32_flop_per_s"],
                nbytes / peak["hbm_byte_per_s"])
    return 100.0 * least / k1_s
