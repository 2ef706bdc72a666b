"""idle_estimators.train: the share of the traced window in which the
device was idle while the host was in an estimator's own code, its chunk
and tile loops (``sk.est.*``) or an increment-grid build (``sk.grid``),
innermost span first, in %."""
from bench_torch import spans


def read(run):
    s = spans.program_idle(run.trace, ("sk.est.", "sk.grid")) \
        if run.trace else None
    return None if s is None else 100.0 * s / run.window_s
