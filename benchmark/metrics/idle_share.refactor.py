"""idle_share.refactor: the share, in %, of the traced steps' wall time in
which no device operation ran: 1 - the trace's device busy seconds over the
wall time of the same steps run just before without the profiler
(``devtrace.idle_share``)."""
from benchmark import devtrace


def read(run):
    return devtrace.idle_share(run.trace, run.untraced_s)
