"""capture_s: seconds of the first step of set-up, whose factorize and
solve build and load the kernels (the first run of a checkout compiles
them), warm up and capture the executor's programs."""


def read(run):
    return run.spans.get("capture")
