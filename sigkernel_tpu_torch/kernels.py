"""Static (state-space) kernels as ``nn.Module``s.

Counterpart of :mod:`sigkernel_tpu.kernels`: ``LinearKernel``,
``RBFKernel`` and the functional-data kernels (``RBF_CEXP_Kernel``,
``RBF_SQR_Kernel``, ``Linear_ID_Kernel``, ``RBF_ID_Kernel`` with the
``CEXP`` lift and ``cos_exp_kernel``). The hyper-parameters (``scale``,
``sigma``, ...) are tensors held as buffers: they follow ``.to(device)`` and
``state_dict``, may require gradients, and are cast to the input dtype and
device at use, as the JAX pytree leaves are. Interface:

- ``batch_kernel(X, Y)``: ``(batch, lx, d) x (batch, ly, d) -> (batch, lx, ly)``
- ``Gram_matrix(X, Y)``: ``(bx, lx, d) x (by, ly, d) -> (bx, by, lx, ly)``

The functional-data kernels also take ``(batch, length_t, length_x, dim)``
arrays of function values.
"""
from __future__ import annotations

import math

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


def _flatten2(X):
    """Collapse trailing function-space axes: ``(..., L, a, b) -> (..., L,
    a*b)``; a no-op for 3-D input."""
    if X.dim() <= 3:
        return X
    return X.reshape(X.shape[0], X.shape[1], -1)


def _as(value, like):
    """A hyper-parameter (number or tensor) in ``like``'s dtype and device."""
    if isinstance(value, torch.Tensor):
        return value.to(like)
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


def cos_exp_kernel(x_y, n_freqs=5, sigma=1.0):
    """Cos-exp kernel on a difference matrix."""
    freqs = torch.arange(n_freqs, dtype=x_y.dtype, device=x_y.device)
    cos_term = torch.cos(2.0 * math.pi * x_y[..., None] * freqs).sum(dim=-1)
    return cos_term * torch.exp(-(x_y ** 2) / _as(sigma, x_y))


def CEXP(X, n_freqs=20, sigma=3.1622776601683795):  # sqrt(10)
    """Integral-operator lift induced by the cos-exp kernel; ``X``:
    ``(batch, length_t, length_x, dim)`` function values on [0, 1]."""
    length_x = X.shape[2]
    grid = torch.linspace(0.0, 1.0, length_x, dtype=X.dtype, device=X.device)
    x_y = grid[:, None] - grid[None, :]
    T = cos_exp_kernel(x_y, n_freqs=n_freqs, sigma=sigma)
    # (batch, length_t, dim, length_x) @ (length_x, length_x)
    out = (1.0 / length_x) * torch.matmul(X.transpose(-1, -2), T)
    return out.transpose(-1, -2)


class RBF_CEXP_Kernel(RBFKernel):
    """RBF kernel (``sigma2``) over the CEXP lift (``n_freqs``, ``sigma1``)
    of functional data."""

    def __init__(self, sigma1, sigma2, n_freqs, *, dtype=None, device=None):
        super().__init__(sigma2, dtype=dtype, device=device)
        self.register_buffer("sigma1", _hyper(sigma1, dtype, device))
        self.n_freqs = n_freqs

    def _lift(self, X):
        C = CEXP(X, self.n_freqs, self.sigma1)
        return C.reshape(X.shape[0], X.shape[1], -1)

    def batch_kernel(self, X, Y):
        return super().batch_kernel(self._lift(X), self._lift(Y))

    def Gram_matrix(self, X, Y):
        return super().Gram_matrix(self._lift(X), self._lift(Y))


class RBF_SQR_Kernel(StaticKernel):
    """Product of an RBF kernel on the values (``sigma1``) and one on the
    squared values (``sigma2``)."""

    def __init__(self, sigma1, sigma2, *, dtype=None, device=None):
        super().__init__()
        self.rbf1 = RBFKernel(sigma1, dtype=dtype, device=device)
        self.rbf2 = RBFKernel(sigma2, dtype=dtype, device=device)

    def batch_kernel(self, X, Y):
        X, Y = _flatten2(X), _flatten2(Y)
        return (self.rbf1.batch_kernel(X, Y)
                * self.rbf2.batch_kernel(X ** 2, Y ** 2))

    def Gram_matrix(self, X, Y):
        X, Y = _flatten2(X), _flatten2(Y)
        return (self.rbf1.Gram_matrix(X, Y)
                * self.rbf2.Gram_matrix(X ** 2, Y ** 2))


class Linear_ID_Kernel(LinearKernel):
    """Linear kernel on flattened functional data (no hyper-parameter: its
    ``scale`` stays 1, as the JAX kernel has no leaf)."""

    def __init__(self, *, dtype=None, device=None):
        super().__init__(dtype=dtype, device=device)

    def batch_kernel(self, X, Y):
        return super().batch_kernel(_flatten2(X), _flatten2(Y))

    def Gram_matrix(self, X, Y):
        return super().Gram_matrix(_flatten2(X), _flatten2(Y))


class RBF_ID_Kernel(RBFKernel):
    """RBF kernel on flattened functional data."""

    def batch_kernel(self, X, Y):
        return super().batch_kernel(_flatten2(X), _flatten2(Y))

    def Gram_matrix(self, X, Y):
        return super().Gram_matrix(_flatten2(X), _flatten2(Y))
