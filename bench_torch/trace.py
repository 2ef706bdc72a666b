"""The traced run's reduction: ``torch.profiler``'s events as plain
intervals, the device's busy time, and the breakdown the result line
carries.

Device intervals are the kernels, copies and sets the profiler saw on the
card (not the annotations it draws there); host intervals are the CPU
operators, runtime calls and the benchmark's own spans. The kernels of the
program's library are told apart by the names in the built library file
itself, so a kernel a later change adds is counted on the right side.
"""
from __future__ import annotations

import heapq
import re
from collections import defaultdict
from typing import NamedTuple


class Interval(NamedTuple):
    name: str
    start: int   # ns
    end: int     # ns


class Trace(NamedTuple):
    device: list
    host: list


def profiler():
    """A profiler of the host and the card, to be entered around the
    window."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def from_profiler(prof) -> Trace:
    """The profiler's events as a :class:`Trace`."""
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation() and "cuda" in str(e.device_type()).lower():
            continue
        iv = Interval(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        if "cuda" in str(e.device_type()).lower():
            device.append(iv)
        else:
            host.append(iv)
    return Trace(device, host)


def merged(intervals):
    """The union of ``intervals`` as sorted, disjoint ``(start, end)``."""
    out = []
    for s, e in sorted((iv.start, iv.end) for iv in intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_seconds(trace: Trace) -> float:
    """Seconds in which some operation ran on the device."""
    return sum(e - s for s, e in merged(trace.device)) * 1e-9


def short_name(name: str, width: int = 96) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."


def device_ops(trace: Trace, top: int = 10):
    """The device operations that took most time, ``[[name, seconds]]``."""
    tot = defaultdict(int)
    for iv in trace.device:
        tot[short_name(iv.name)] += iv.end - iv.start
    return [[n, t * 1e-9] for n, t in
            sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(trace: Trace, top: int = 10):
    """Idle time between device operations, ``[[what the host was doing,
    seconds]]``: each gap is put to the innermost host interval running at
    its middle (the one that started last)."""
    spans = merged(trace.device)
    host = sorted(trace.host, key=lambda iv: iv.start)
    tot = defaultdict(int)
    open_, h = [], 0   # a heap of the host intervals begun, latest first
    for (_, a), (b, _) in zip(spans, spans[1:]):
        mid = (a + b) // 2
        while h < len(host) and host[h].start <= mid:
            heapq.heappush(open_, (-host[h].start, h))
            h += 1
        while open_ and host[open_[0][1]].end < mid:
            heapq.heappop(open_)
        name = short_name(host[open_[0][1]].name) if open_ else "(no host span)"
        tot[name] += b - a
    return [[n, t * 1e-9] for n, t in
            sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def _demangled_prefix(sym: str):
    """The qualified function name of an Itanium-mangled symbol, as a
    demangler prints it before any template arguments."""
    s = sym[2:]
    nested = s.startswith("N")
    if nested:
        s = s[1:]
    parts = []
    while s and s[0].isdigit():
        m = re.match(r"\d+", s)
        n = int(m.group())
        part = s[m.end():m.end() + n]
        parts.append("(anonymous namespace)" if part.startswith("_GLOBAL__N")
                     else part)
        s = s[m.end() + n:]
        if not nested:
            break
    return "::".join(parts) or None


def library_names(path) -> set:
    """The qualified names of the functions in the built library file."""
    data = open(path, "rb").read()
    names = set()
    for sym in re.findall(rb"_Z[A-Za-z0-9_]+", data):
        n = _demangled_prefix(sym.decode())
        if n:
            names.add(n)
    return names


def function_name(kernel: str) -> str:
    """A demangled kernel name's qualified function name."""
    k = kernel[5:] if kernel.startswith("void ") else kernel
    return re.split(r"[<(]", k, maxsplit=1)[0].strip()


def library_seconds(trace: Trace, names: set):
    """``(seconds in the library's kernels, seconds in every device
    operation)``, summed over the trace."""
    lib = tot = 0
    for iv in trace.device:
        d = iv.end - iv.start
        tot += d
        if function_name(iv.name) in names:
            lib += d
    return lib * 1e-9, tot * 1e-9
