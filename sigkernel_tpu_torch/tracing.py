"""Spans of the program in the profiler's trace.

A span is a ``torch.profiler.record_function`` annotation, so it lands in
the trace a ``torch.profiler.profile`` records, on the clock of the device's
kernels: an idle gap of the device can be put down to the span open on the
host at that time. Spans are opened only while a profiler records; with
none recording, a span site costs one attribute read and creates no object.

Names, by layer:

- ``sk.est.<estimator>``: one call of a public estimator; ``sk.est.chunk``
  and ``sk.est.tile``: one pass of an estimator's pair-chunk or tile loop
  (the Autograd Functions' loops included);
- ``sk.grid``: one increment grid built in PyTorch (``double_difference``
  of the static kernel's Gram);
- ``sk.op.<kernel>``: one call of a launching entry of :mod:`.ops`, from
  its input checks to its last launch, named as its launches are counted;
- ``sk.sync.<site>``: a device value read on the host (:func:`host`), or a
  PyTorch call that waits for the device to check its result.
"""
from __future__ import annotations

import contextlib
import functools

from torch.autograd import profiler as _profiler

# the span returned while no profiler records: shared, stateless
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: ``record_function(name)`` while a profiler
    records, else a shared no-op."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """Decorator: every call of the function inside :func:`span` ``(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _profiler.record_function(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def host(t, site: str):
    """``t.tolist()``: the one way the program reads a device value on the
    host, inside the span ``sk.sync.<site>`` while a profiler records."""
    if not _profiler._is_profiler_enabled:
        return t.tolist()
    with _profiler.record_function("sk.sync." + site):
        return t.tolist()
