"""call_roofline.train: the least time of the window's calls' mathematics
(``work.py``, counted from their shapes) over the device's busy time in
the trace, in %."""
from bench_torch import trace


def read(run):
    busy = trace.busy_seconds(run.trace) if run.trace else 0.0
    return 100.0 * run.least_s / busy if busy > 0 else None
