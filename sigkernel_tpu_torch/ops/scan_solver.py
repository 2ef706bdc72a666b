"""Plain PyTorch Goursat PDE solver: a loop over anti-diagonals.

Counterpart of :mod:`sigkernel_tpu.ops.scan_solver` and the port's plain
tier: any dtype, any device, vectorised over the whole batch. It is what
the CPU runs and what the CUDA kernels are held to on the card.

The solution grid ``K`` of shape ``(MM+1, NN+1)`` (boundary
``K[0, :] = K[:, 0] = 1``) is swept one anti-diagonal ``p = i + j`` at a
time, keeping the last three diagonals in a ring indexed by the row ``i``:
``ring[p % 3][..., i] = K[i, p - i]``. An interior cell reads (with
``u = inc[i-1, j-1]``)::

    K[i, j] = scheme(k00=K[i-1, j-1], k01=K[i-1, j], k10=K[i, j-1], u)

and only rows ``max(1, p - NN) <= i <= min(MM, p - 1)`` are written, so row
0 and the not-yet-reached row ``p`` keep their boundary value 1.
"""
from __future__ import annotations

import math

import torch


def _update_naive(k00, k01, k10, u):
    """First-order scheme: ``(k01+k10)(1 + u/2) - k00``."""
    return (k01 + k10) * (1.0 + 0.5 * u) - k00


def _update_order2(k00, k01, k10, u):
    """Higher-order scheme: ``(k01+k10)(1 + u/2 + u^2/12) - k00(1 - u^2/12)``."""
    u2 = u * u * (1.0 / 12.0)
    return (k01 + k10) * (1.0 + 0.5 * u + u2) - k00 * (1.0 - u2)


def get_scheme(naive: bool):
    return _update_naive if naive else _update_order2


def _sweep(inc: torch.Tensor, naive: bool, return_grid: bool):
    """Sweep ``inc`` (``(..., MM, NN)``); returns ``(final, grid_or_None)``."""
    *batch, MM, NN = inc.shape
    if MM == 0 or NN == 0:
        # degenerate (length-1) path: the solution is the boundary, K == 1
        grid = (inc.new_ones(*batch, MM + 1, NN + 1) if return_grid
                else None)
        return inc.new_ones(batch), grid

    scheme = get_scheme(naive)
    flat = inc.reshape(math.prod(batch), MM, NN)
    ring = inc.new_ones(3, flat.shape[0], MM + 1)
    grid = (inc.new_ones(flat.shape[0], MM + 1, NN + 1) if return_grid
            else None)
    rows = torch.arange(MM + 1, device=inc.device)
    for p in range(2, MM + NN + 1):
        lo, hi = max(1, p - NN), min(MM, p - 1)
        i = rows[lo:hi + 1]
        m2, m1 = ring[(p - 2) % 3], ring[(p - 1) % 3]
        v = scheme(m2[:, lo - 1:hi], m1[:, lo - 1:hi], m1[:, lo:hi + 1],
                   flat[:, i - 1, p - 1 - i])
        ring[p % 3][:, lo:hi + 1] = v
        if grid is not None:
            grid[:, i, p - i] = v
    final = ring[(MM + NN) % 3][:, MM].reshape(batch)
    if grid is not None:
        grid = grid.reshape(*batch, MM + 1, NN + 1)
    return final, grid


def solve_final(inc: torch.Tensor, naive: bool = False) -> torch.Tensor:
    """Solve the Goursat PDE; return only the final corner ``K[..., -1, -1]``."""
    return _sweep(inc, naive, return_grid=False)[0]


def solve_grid(inc: torch.Tensor, naive: bool = False) -> torch.Tensor:
    """Solve the Goursat PDE; return the full ``(..., MM+1, NN+1)`` grid."""
    return _sweep(inc, naive, return_grid=True)[1]
