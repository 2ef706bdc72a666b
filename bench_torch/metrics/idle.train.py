"""idle.train: the share of the traced window in which no operation ran on
the device, in %."""
from bench_torch import trace


def read(run):
    busy = trace.busy_seconds(run.trace) if run.trace else 0.0
    return 100.0 * (1.0 - busy / run.window_s) if busy > 0 else None
