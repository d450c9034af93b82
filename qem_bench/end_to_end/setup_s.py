"""Process start to the first timed call: imports, kernels loaded (or
built on a checkout's first run), inputs and the warm-up."""


def read(run):
    return run.setup_s
