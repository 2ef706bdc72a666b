"""call_roofline.uea: the least time of the window's calls' mathematics over
the device's busy time in the trace, in %, for the model-selection pass,
whose Grams run at the shapes its transforms make (the kind's ``shapes``:
144 x 10 and 287 x 19 at ArticularyWordRecognition's size), not at the
configuration's own 144 x 9: at each shape, every sigma's train and test
Gram pairs (``work.call_work``), the paths read once, the Grams written
once, and the static kernel's ``point_ops`` at that shape's dim."""
from bench_torch import trace, work


def least_seconds(cell):
    """The least time of one call, summed over the transforms' shapes."""
    cfg, mix = cell.config, cell.mix
    n, m = mix["paths"]["X"], mix["paths"]["T"]
    k = len(cfg["sigmas"])
    f = 2 ** cfg["dyadic_order"]
    total = 0.0
    for _, L, D in cell.kind.shapes(cfg):
        values, ops = work.call_work(
            k * (n * (n + 1) // 2 + m * n), L, L, D, f, False, n + m,
            k * (n * n + m * n), cell.static.point_ops(D, False))
        total += work.least_seconds(values, ops, cfg["dtype"])
    return total


def read(run):
    busy = trace.busy_seconds(run.trace) if run.trace else 0.0
    if busy <= 0 or not hasattr(run.cell.kind, "shapes"):
        return None
    return 100.0 * least_seconds(run.cell) * run.calls / busy
