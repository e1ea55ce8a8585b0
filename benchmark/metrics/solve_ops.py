"""solve_ops: device operations per ``CholeskySolver.solve`` in the traced
steps, averaged over the solve spans."""
from benchmark import devtrace


def read(run):
    rows = devtrace.per_span(run.trace, "solve")
    return sum(n for _, n in rows) / len(rows) if rows else None
