"""syncs.train: the program's host reads of device values a call: its
``sk.sync.*`` spans in the traced window over the window's calls. None
untraced, or where the program opens no ``sk.`` span."""


def read(run):
    if not run.trace or not run.calls:
        return None
    names = [iv.name for iv in run.trace.host if iv.name.startswith("sk.")]
    if not names:
        return None
    return sum(n.startswith("sk.sync.") for n in names) / run.calls
