"""Small shape/grid utilities shared across the port.

Counterpart of :mod:`sigkernel_tpu.utils`: the increment grid of the
Goursat PDE (a double difference of the static-kernel Gram), its dyadic
refinement, and the padding helpers the estimators use.
"""
from __future__ import annotations

import torch


def double_difference(G: torch.Tensor) -> torch.Tensor:
    """Second-order mixed finite difference over the last two axes.

    ``dd[..., i, j] = G[i+1,j+1] + G[i,j] - G[i+1,j] - G[i,j+1]``: the
    discrete ``d/ds d/dt k(x_s, y_t)`` increment grid feeding the PDE
    solve. Input ``(..., M, N)`` -> output ``(..., M-1, N-1)``.
    """
    return (
        G[..., 1:, 1:] + G[..., :-1, :-1] - G[..., 1:, :-1] - G[..., :-1, 1:]
    )


def dd_transpose(ct: torch.Tensor) -> torch.Tensor:
    """Transpose (VJP) of :func:`double_difference`: ``(..., M-1, N-1)``
    -> ``(..., M, N)``. Zero-padding ``ct`` by one on each side turns the
    scatter into the forward stencil: ``double_difference(pad(ct, 1))``."""
    return double_difference(torch.nn.functional.pad(ct, (1, 1, 1, 1)))


def dyadic_refine(dd: torch.Tensor, dyadic_order: int) -> torch.Tensor:
    """Split each increment cell into ``2^d x 2^d`` sub-cells, each carrying
    ``1/4^d`` of the original increment."""
    if dyadic_order == 0:
        return dd
    f = 2 ** dyadic_order
    dd = torch.repeat_interleave(dd, f, dim=-2)
    dd = torch.repeat_interleave(dd, f, dim=-1)
    return dd / (f * f)


def increment_grid(G: torch.Tensor, dyadic_order: int) -> torch.Tensor:
    """Static-kernel Gram -> dyadically refined PDE increment grid."""
    return dyadic_refine(double_difference(G), dyadic_order)


def refined_size(length: int, dyadic_order: int) -> int:
    """Number of increment cells along one axis: ``2^d * (length - 1)``."""
    return (2 ** dyadic_order) * (length - 1)


def ceil_to(x: int, m: int) -> int:
    """Round ``x`` up to a multiple of ``m``."""
    return -(-x // m) * m


def pad_length(X: torch.Tensor, multiple: int) -> torch.Tensor:
    """Pad paths along the length axis by repeating the final point.

    A repeated point gives zero increments, which are exact no-ops for both
    PDE schemes and any static kernel, so bucketing lengths is free.
    """
    rem = (-X.shape[-2]) % multiple
    if rem == 0:
        return X
    last = X[..., -1:, :].expand(*X.shape[:-2], rem, X.shape[-1])
    return torch.cat([X, last], dim=-2)


def pad_batch(X: torch.Tensor, multiple: int):
    """Zero-pad the leading axis to a multiple; returns ``(padded, n)``."""
    n = X.shape[0]
    rem = (-n) % multiple
    if rem:
        X = torch.cat([X, X.new_zeros((rem,) + tuple(X.shape[1:]))], dim=0)
    return X, n


def flip(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Reverse along an axis (the reference's ``flip`` helper)."""
    return torch.flip(x, dims=(dim,))


def tile(a: torch.Tensor, dim: int, n_tile: int) -> torch.Tensor:
    """Interleaved repeat along an axis: each element ``n_tile`` times in a
    row (the reference's ``tile`` helper)."""
    return torch.repeat_interleave(a, n_tile, dim=dim)
