"""Seconds from process start to the first timed job: imports, loading (or
the first time in a checkout, building) the kernels, making the data, and
warming up the cell's shapes."""


def read(run):
    return run.setup_s
