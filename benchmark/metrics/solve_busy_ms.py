"""solve_busy_ms: device busy ms per ``CholeskySolver.solve`` in the
traced steps (b's upload, the captured leveled forward and backward
solves, x's copy back), averaged over the solve spans."""
from benchmark import devtrace


def read(run):
    rows = devtrace.per_span(run.trace, "solve")
    return sum(b for b, _ in rows) / len(rows) * 1e3 if rows else None
