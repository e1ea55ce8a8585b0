"""factorize_busy_ms: device busy ms per ``CholeskySolver.factorize`` in
the traced steps: the union of the device operations that started inside
each factorize span (the values' upload, the captured step loop, the
pools' copies and the SPD check), averaged over the spans."""
from benchmark import devtrace


def read(run):
    rows = devtrace.per_span(run.trace, "factorize")
    return sum(b for b, _ in rows) / len(rows) * 1e3 if rows else None
