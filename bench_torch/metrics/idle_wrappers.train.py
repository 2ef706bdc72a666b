"""idle_wrappers.train: the share of the traced window in which the device
was idle while the host was inside a kernel wrapper of ``ops/``
(``sk.op.*``) or a host read (``sk.sync.*``), innermost span first, in %."""
from bench_torch import spans


def read(run):
    s = spans.program_idle(run.trace, ("sk.op.", "sk.sync.")) \
        if run.trace else None
    return None if s is None else 100.0 * s / run.window_s
