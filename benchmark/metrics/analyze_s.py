"""analyze_s: seconds of ``CholeskySolver``'s construction, the host
inspector (ordering, etree and column counts, the supernodal plan, the
executor's tables); the stages are ``CholeskySolver.timings``, printed in
the set-up line."""


def read(run):
    return run.spans.get("analyze")
