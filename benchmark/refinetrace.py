"""What the refinement's device operations give the per-layer metrics,
read from the traced window (``devtrace.Trace``).

``CholeskySolver.solve`` with ``refine_steps`` = k runs on one stream, in
this order, inside the harness's ``solve`` span: b's upload and the first
solve, then k sweeps, each the residual, the correction's solve and x's
update, then x's copy back (the span's last ``DtoH`` copy).  A residual
(``ops/residual.SymmetricResidual``) is ``RESIDUAL_OPS`` operations, the
last of them ``index_add_``'s kernel on float64 values and int32 indices,
whose name holds both parts of ``KERNEL``: b's copy into r, two gathers,
their product and the scatter-add.  The solves' own ``index_add_``
scatters take the factor's dtype and int64 indices.  The
program's own spans (``solver.refine``, ``solver.residual``) are host
spans that end before the device has run what they launched, so the
device operations are found by that order: each residual is a
scatter-add and the ``RESIDUAL_OPS`` - 1 operations before it.  So a
change to the residual's operations changes this yardstick, and this
file has to change with it.

A solve span is read where it holds exactly as many scatter-adds as the
configuration asks for sweeps and the solver's sweep counter
(``refine_sweeps``) agrees; a program without the counter gives nothing,
and so does a trace without device operations (the CPU).
"""
from __future__ import annotations

from benchmark import devtrace

#: in the names torch.profiler gives ``index_add_``'s CUDA kernels
#: (``indexFuncSmallIndex``, ``indexFuncLargeIndex``) and their template
#: arguments at float64 values and int32 indices
KERNEL = ("indexFunc", "<double, int,")
#: the operations of one residual, the scatter-add last
RESIDUAL_OPS = 5
FETCH = "DtoH"


def sweeps(run):
    """The configuration's ``refine_steps``, or None where the solver's
    counter of the last solve's sweeps is missing or disagrees."""
    want = int(run.cell.config["solver"].get("refine_steps", 0))
    got = getattr(getattr(run.system, "solver", None), "refine_sweeps", None)
    return want if want and got == want else None


def solves(run):
    """[(ops of one solve span, [index of each residual's first
    operation])] over the traced solve spans that hold the configured
    sweeps, the residuals apart from each other and from the span's
    first operation."""
    tr, k = run.trace, sweeps(run)
    if tr is None or not tr.ops or k is None:
        return []
    out = []
    for ops in tr.ops_in("solve"):
        at = [i - RESIDUAL_OPS + 1 for i, op in enumerate(ops)
              if all(k in op[0] for k in KERNEL)]
        if (len(at) == k and at[0] > 0
                and all(b - a >= RESIDUAL_OPS for a, b in zip(at, at[1:]))):
            out.append((ops, at))
    return out


def refine_ms(run):
    """Device busy ms per traced solve from the first residual's first
    operation to the operation before x's copy back: the refinement's
    sweeps."""
    rows = []
    for ops, at in solves(run):
        end = max((i for i, op in enumerate(ops) if FETCH in op[0]),
                  default=None)
        if end is None or end < at[-1] + RESIDUAL_OPS:
            continue
        rows.append(devtrace.union([op[1:] for op in ops[at[0]:end]]))
    return sum(rows) / len(rows) / 1e3 if rows else None


def residual_s(run):
    """Device busy seconds per residual, its ``RESIDUAL_OPS`` operations,
    averaged over the residuals of the traced solves."""
    rows = [devtrace.union([op[1:] for op in ops[i:i + RESIDUAL_OPS]])
            for ops, at in solves(run) for i in at]
    return sum(rows) / len(rows) / 1e6 if rows else None
