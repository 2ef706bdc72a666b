"""Static (state-space) kernels as ``nn.Module``s.

Counterpart of :mod:`sigkernel_tpu.kernels` (``LinearKernel`` and
``RBFKernel``). The hyper-parameters (``scale``, ``sigma``) are tensors held
as buffers: they follow ``.to(device)`` and ``state_dict``, and are cast to
the input dtype and device at use, as the JAX pytree leaves are. Interface:

- ``batch_kernel(X, Y)``: ``(batch, lx, d) x (batch, ly, d) -> (batch, lx, ly)``
- ``Gram_matrix(X, Y)``: ``(bx, lx, d) x (by, ly, d) -> (bx, by, lx, ly)``
"""
from __future__ import annotations

import torch
from torch import nn


def _hyper(value, dtype, device) -> torch.Tensor:
    """A hyper-parameter as a tensor; Python numbers default to float64."""
    if dtype is None and not isinstance(value, torch.Tensor):
        dtype = torch.float64
    return torch.as_tensor(value, dtype=dtype, device=device)


class StaticKernel(nn.Module):
    """Base class; subclasses implement ``batch_kernel`` and ``Gram_matrix``."""

    def batch_kernel(self, X, Y):  # pragma: no cover - interface
        raise NotImplementedError

    def Gram_matrix(self, X, Y):  # pragma: no cover - interface
        raise NotImplementedError

    def gram_matrix(self, X, Y):
        return self.Gram_matrix(X, Y)


class LinearKernel(StaticKernel):
    """Linear kernel ``k(x, y) = scale^2 <x, y>``; ``Gram_matrix`` applies
    ``scale**2`` too (the reference ignores it there)."""

    def __init__(self, scale=1.0, *, dtype=None, device=None):
        super().__init__()
        self.register_buffer("scale", _hyper(scale, dtype, device))

    def batch_kernel(self, X, Y):
        s2 = self.scale.to(X) ** 2
        return s2 * torch.einsum("bpk,bqk->bpq", X, Y)

    def Gram_matrix(self, X, Y):
        s2 = self.scale.to(X) ** 2
        return s2 * torch.einsum("ipk,jqk->ijpq", X, Y)


class RBFKernel(StaticKernel):
    """RBF kernel ``k(x, y) = exp(-|x - y|^2 / sigma)``.

    Divides by ``sigma`` (not ``sigma^2``), as the reference does.
    """

    def __init__(self, sigma, *, dtype=None, device=None):
        super().__init__()
        self.register_buffer("sigma", _hyper(sigma, dtype, device))

    def batch_kernel(self, X, Y):
        Xs = torch.sum(X ** 2, dim=-1)
        Ys = torch.sum(Y ** 2, dim=-1)
        d = -2.0 * torch.einsum("bpk,bqk->bpq", X, Y)
        d = d + Xs[:, :, None] + Ys[:, None, :]
        return torch.exp(-d / self.sigma.to(X))

    def Gram_matrix(self, X, Y):
        Xs = torch.sum(X ** 2, dim=-1)
        Ys = torch.sum(Y ** 2, dim=-1)
        d = -2.0 * torch.einsum("ipk,jqk->ijpq", X, Y)
        d = d + Xs[:, None, :, None] + Ys[None, :, None, :]
        return torch.exp(-d / self.sigma.to(X))
