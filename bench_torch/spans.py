"""The program's own spans in a traced run (``sigkernel_tpu_torch.tracing``:
``sk.est.*``, ``sk.grid``, ``sk.op.*``, ``sk.sync.*``): the device's idle
time charged to the span the host was in."""
from __future__ import annotations

from bench_torch import trace as tr


def program_idle(trace, prefixes):
    """Seconds of the gaps between the merged device intervals charged to a
    span whose name starts with one of ``prefixes``: each gap goes to the
    innermost ``sk.`` span open at its middle (the one started last, on any
    thread, as :func:`.trace.idle_gaps` charges a gap); a gap with none
    open, the caller's own time between calls, to none. ``None`` when the
    trace holds no device interval or no ``sk.`` span: nothing to read."""
    mine = [iv for iv in trace.host if iv.name.startswith("sk.")]
    if not trace.device or not mine:
        return None
    gaps = tr.idle_gaps(tr.Trace(trace.device, mine), top=None)
    return sum(s for name, s in gaps if name.startswith(tuple(prefixes)))
