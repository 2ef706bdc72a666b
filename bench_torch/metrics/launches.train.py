"""launches.train: the program's kernel launches a call in the window, from
its launch counters."""


def read(run):
    return run.launches / run.calls if run.library and run.calls else None
