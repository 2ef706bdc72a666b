"""setup_s: process start to the first timed call, on the host clock: the
CUDA context, loading (on a checkout's first run, building) the program's
kernels, the warm call of the cell's own shape."""


def read(run):
    return run.setup_s
