"""Performance model: per-kernel speed-of-light accounting for the plan.

Reference: cholesky/performanceModel.h — flop macros (OPS_GEMM/TRSM/PPF
:19-21), machine-calibrated per-kernel time models (:26-88), per-supernode
cost ``computeCostperBlock`` (:151) and schedule communication analysis
``computeComCost`` (:194).  The port's copy of
``parsy_bench_tpu/utils/perfmodel.py``: the same features
(``segment_features``), the same time model (``_segment_time``) and the
same reports, so a plan is priced as the JAX package prices it; only the
machine differs.  Here the machine is one NVIDIA GPU behind the port's
captured programs, and ``ChipModel``'s constants are fitted on the card by
``utils/calibrate.py`` from ``profile_segments``.  The model's terms:

* **row movement** — index-driven gathers and scatters priced per row
  moved (``gather_rows``, ``scatter_rows``), not per byte;
* **per-lane batched-product cost** — each lane of a batched small
  product costs ``lane_s`` on top of its flops (``mxu_flops``);
* **sequential-op latency** — each dependent step of the blocked
  Cholesky chain costs ``chain_op_s``, and each level step and bucket a
  fixed ``step_s``, ``upd_bucket_s`` or ``fin_bucket_s``.

The report tells whether a slow factorization is a scheduling problem
(steps, chains), a batching problem (lanes) or a data-movement problem
(rows), which is what the ladder and segmentation knobs tune.
"""
from __future__ import annotations

import dataclasses

from parsy_bench_tpu_torch.symbolic.splan import SupernodalPlan


@dataclasses.dataclass(frozen=True)
class ChipModel:
    """Throughputs and fixed costs of one card behind the port's captured
    programs: the least-squares fit (``utils/calibrate.fit``) of the
    per-segment device times that ``profile_segments`` measured (each
    segment from its restored input, the restore subtracted) on the
    ``laplace_3d(48)`` plan (n = 110,592, ND, f32, ``update_delta="gather"``)
    in ``chip_smoke.py``'s phase 17, on an NVIDIA H100 80GB HBM3 with a
    700 W power limit (R^2 0.998 over the plan's 34 segments; PERF.md §5
    compares the fits of several runs).  A rate the fit left at zero cost
    is ``inf``, a fixed cost ``0.0``.  Each bucket of a level step is a
    chain of dependent device operations, so the per-bucket fixed costs
    (``upd_bucket_s``, ``fin_bucket_s``) are what segmentation and the q
    ladder trade against padding."""
    name: str = "NVIDIA H100 80GB HBM3, 700.00 W (chip_smoke.py phase 17)"
    #: batched-product flops/s
    mxu_flops: float = 17238378051455.73
    #: index-driven row gathers, rows/s
    gather_rows: float = 179922797.92783147
    #: row scatter-adds, rows/s (fitted at no cost)
    scatter_rows: float = float("inf")
    #: window slice and update bytes/s
    stream_bytes: float = 425437503046.8483
    #: per batched-product lane (fitted at no cost)
    lane_s: float = 0.0
    #: per dependent step of the blocked Cholesky chain (fitted at no cost)
    chain_op_s: float = 0.0
    #: per level step (fitted at no cost)
    step_s: float = 0.0
    #: per update bucket per level step
    upd_bucket_s: float = 3.291219416163601e-05
    #: per finalize bucket per level step
    fin_bucket_s: float = 5.042531576024375e-05


@dataclasses.dataclass
class KernelCost:
    label: str
    flops: float          # padded flops executed
    rows: float           # gather/scatter rows moved
    count: float          # batch lanes x steps
    model_s: float        # modeled time


@dataclasses.dataclass
class PlanCostReport:
    kernels: list[KernelCost]
    true_flops: float
    padded_flops: float
    model_s: float
    steps: int

    @property
    def padding_efficiency(self) -> float:
        return self.true_flops / max(self.padded_flops, 1.0)

    @property
    def speed_of_light_gflops(self) -> float:
        """GFLOP/s the model says this plan can reach on the chip."""
        return self.true_flops / self.model_s / 1e9

    def summary(self) -> dict:
        return {
            "model_s": round(self.model_s, 6),
            "true_gflop": round(self.true_flops / 1e9, 4),
            "padded_gflop": round(self.padded_flops / 1e9, 4),
            "padding_efficiency": round(self.padding_efficiency, 4),
            "speed_of_light_gflops": round(self.speed_of_light_gflops, 3),
            "sequential_steps": self.steps,
        }


def segment_features(seg, classes, dtype_bytes: int = 4) -> dict:
    """Structural feature vector of one segment — the quantities the
    ChipModel prices.  Shared by the model and its calibration fit
    (utils/calibrate.py), so fitted constants and modeled costs
    can never drift apart."""
    T = seg.nsteps
    f = dict(steps=float(T), wbytes=0.0, upd_buckets=0.0, upd_lanes=0.0,
             upd_flops=0.0, grows=0.0, srows=0.0, fin_buckets=0.0,
             fin_lanes=0.0, fin_flops=0.0, fin_bytes=0.0, chain_cols=0.0)
    f["wbytes"] = 2.0 * dtype_bytes * T * sum(
        seg.wslice[ci] * c for ci, c in enumerate(classes))
    for b in seg.upd:
        G, _, P = b.arow.shape
        lanes = G * T * P
        f["upd_buckets"] += T
        f["upd_lanes"] += 2.0 * lanes          # two einsums per bucket
        f["upd_flops"] += 2.0 * lanes * b.Mc * b.Q * (b.K + b.c)
        f["grows"] += lanes * (b.Mc / 8.0 + b.Q / 8.0)  # packed fat rows
        f["srows"] += lanes * b.Mc
    fin_cls = set()
    for b in seg.fin:
        lanes = T * b.P
        f["fin_buckets"] += T
        f["fin_lanes"] += lanes
        f["fin_flops"] += (lanes * b.c ** 3 / 3.0 * 4.0
                           + 2.0 * lanes * b.H * b.c ** 2)
        # the model prices a class narrower than 128 at 4x its bytes
        pad = 4.0 if b.c < 128 else 1.0
        f["fin_bytes"] += pad * dtype_bytes * lanes * b.H * b.c * 2
        fin_cls.add(b.ccls)
    # ONE shared blocked Cholesky chain per (present class, step)
    f["chain_cols"] = float(T * sum(2.5 * classes[ci] + 40
                                    for ci in fin_cls))
    return f


def _segment_time(f: dict, chip: ChipModel) -> float:
    return (f["steps"] * chip.step_s
            + f["wbytes"] / chip.stream_bytes
            + f["upd_buckets"] * chip.upd_bucket_s
            + f["upd_lanes"] * chip.lane_s
            + f["upd_flops"] / chip.mxu_flops
            + f["grows"] / chip.gather_rows
            + f["srows"] / chip.scatter_rows
            + f["fin_buckets"] * chip.fin_bucket_s
            + f["fin_lanes"] * chip.lane_s
            + f["fin_flops"] / chip.mxu_flops
            + f["fin_bytes"] / chip.stream_bytes
            + f["chain_cols"] * chip.chain_op_s)


def factorize_cost(plan: SupernodalPlan, chip: ChipModel | None = None,
                   dtype_bytes: int = 4) -> PlanCostReport:
    """Model the supernodal factorization time on one chip."""
    chip = chip or ChipModel()
    kernels: list[KernelCost] = []
    padded_flops = 0.0
    steps = 0
    total = 0.0
    classes = plan.classes
    for si, seg in enumerate(plan.segments):
        f = segment_features(seg, classes, dtype_bytes)
        t = _segment_time(f, chip)
        kernels.append(KernelCost(
            f"seg{si}", f["upd_flops"] + f["fin_flops"],
            f["grows"] + f["srows"],
            f["upd_lanes"] + f["fin_lanes"], t))
        padded_flops += f["upd_flops"] + f["fin_flops"]
        steps += seg.nsteps
        total += t
    return PlanCostReport(kernels=kernels, true_flops=plan.flops,
                          padded_flops=padded_flops, model_s=total,
                          steps=steps)


def comm_cost(plan: SupernodalPlan, dtype_bytes: int = 4) -> dict:
    """Schedule communication analysis for the SPMD executor (reference:
    computeComCost, performanceModel.h:194 — intra/inter-partition
    contribution volumes and edge cuts become psum volumes here).  The
    psum payload is the per-level delta window."""
    G = plan.nshards
    psum_bytes = sum(seg.nsteps * dtype_bytes * sum(
        (seg.wslice[ci] + 1) * c for ci, c in enumerate(plan.classes))
        for seg in plan.segments if seg.upd)
    lanes = sum(b.arow.shape[0] * seg.nsteps * b.arow.shape[2]
                for seg in plan.segments for b in seg.upd)
    return {
        "partitions": G,
        "psum_steps": sum(s.nsteps for s in plan.segments if s.upd),
        "psum_bytes_per_factorize": int(psum_bytes),
        "update_lanes": int(lanes),
    }
