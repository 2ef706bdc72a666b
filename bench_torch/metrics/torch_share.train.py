"""torch_share.train: the share of the device's operation time spent
outside the program's own library, in % (the increment grids built in
PyTorch, their autograd, copies and fills). The library's kernels are told
apart by the names in the built library file."""
from bench_torch import trace


def read(run):
    if not run.trace or not run.library:
        return None
    lib, tot = trace.library_seconds(run.trace,
                                     trace.library_names(run.library))
    return 100.0 * (tot - lib) / tot if tot > 0 else None
