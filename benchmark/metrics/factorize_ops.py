"""factorize_ops: device operations per ``CholeskySolver.factorize`` in
the traced steps, averaged over the factorize spans."""
from benchmark import devtrace


def read(run):
    rows = devtrace.per_span(run.trace, "factorize")
    return sum(n for _, n in rows) / len(rows) if rows else None
