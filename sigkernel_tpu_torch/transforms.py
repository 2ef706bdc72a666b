"""Path transforms: scaling, the lead-lag embedding and a time channel.

Counterpart of :func:`sigkernel_tpu.transforms.transform`, ``AddTime`` and
``LeadLag``, batched: each takes a ``(batch, length, dim)`` tensor and
returns a new one on the same device and in the same dtype, with no loop
over the paths, so the preprocessing of a Gram's paths runs where the Gram
does. The arithmetic is the JAX package's numpy pipeline, operation for
operation: on float64 tensors the results are bit for bit its results.
"""
from __future__ import annotations

import torch

from .tracing import spanned


def _linspace(start: float, stop: float, num: int, device) -> torch.Tensor:
    """``numpy.linspace(start, stop, num)`` in float64, by its arithmetic:
    ``arange(num) * step + start`` with ``step = (stop - start) / (num - 1)``
    (``arange / (num - 1) * delta`` where the step underflows to 0), and
    the last point set to ``stop``."""
    t = torch.arange(num, dtype=torch.float64, device=device)
    div, delta = num - 1, stop - start
    if div > 0:
        step = delta / div
        t = t / div * delta if step == 0 else t * step
    else:
        t = t * delta
    t = t + start
    if num > 1:
        t[-1] = stop
    return t


class AddTime:
    """Prepend a time channel running from ``init_time`` to ``init_time +
    total_time`` in equal steps, as ``numpy.linspace`` spaces it."""

    def __init__(self, init_time=0.0, total_time=1.0):
        self.init_time = init_time
        self.total_time = total_time

    def fit(self, X, y=None):
        return self

    def transform(self, X, y=None):
        B, L, _ = X.shape
        t = _linspace(self.init_time, self.init_time + self.total_time, L,
                      X.device).to(X.dtype)
        return torch.cat([t.expand(B, L)[..., None], X], dim=-1)

    def fit_transform(self, X, y=None):
        return self.fit(X, y).transform(X)


class LeadLag:
    """The lead-lag embedding: a path of ``L`` points of ``D`` channels
    becomes one of ``2 L - 1`` points of ``2 D``, the lag half then the lead
    half: each point doubled, the lag's copy taken one row behind the
    lead's."""

    def fit(self, X, y=None):
        return self

    def transform(self, X, y=None):
        doubled = X.repeat_interleave(2, dim=1)
        return torch.cat([doubled[:, :-1], doubled[:, 1:]], dim=-1)

    def fit_transform(self, X, y=None):
        return self.fit(X, y).transform(X)


@spanned("sk.est.transform")
def transform(paths, at=False, ll=False, scale=1.0):
    """``scale`` times the paths, then the lead-lag embedding (``ll``), then
    a time channel first (``at``): ``(batch, length, dim)`` in, a new tensor
    of the same device and dtype out."""
    paths = paths * scale
    if ll:
        paths = LeadLag().fit_transform(paths)
    if at:
        paths = AddTime().fit_transform(paths)
    return paths
