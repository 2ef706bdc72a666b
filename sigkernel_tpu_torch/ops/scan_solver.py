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


def _sweep(inc: torch.Tensor, naive: bool, return_grid: bool, bd=None):
    """Sweep ``inc`` (``(..., MM, NN)``); returns ``(final, grid_or_None,
    bottom_or_None)``. With ``bd`` (``(..., NN+1)``) row 0 is that north
    boundary instead of 1, and the bottom row ``K[MM, :]`` comes back too."""
    *batch, MM, NN = inc.shape
    if MM == 0 or NN == 0:
        # degenerate (length-1) path: the solution is the boundary, K == 1
        grid = (inc.new_ones(*batch, MM + 1, NN + 1) if return_grid
                else None)
        if bd is not None and grid is not None:
            grid[..., 0, :] = bd
        bottom = None if bd is None else (
            bd.clone() if MM == 0 else inc.new_ones(*batch, 1))
        final = inc.new_ones(batch) if bottom is None else bottom[..., -1]
        return final, grid, bottom

    scheme = get_scheme(naive)
    B = math.prod(batch)
    flat = inc.reshape(B, MM, NN)
    ring = inc.new_ones(3, B, MM + 1)
    grid = inc.new_ones(B, MM + 1, NN + 1) if return_grid else None
    bottom = None
    if bd is not None:
        bd = bd.reshape(B, NN + 1)
        ring[0][:, 0], ring[1][:, 0] = bd[:, 0], bd[:, 1]
        bottom = inc.new_ones(B, NN + 1)
        if grid is not None:
            grid[:, 0, :] = bd
    rows = torch.arange(MM + 1, device=inc.device)
    for p in range(2, MM + NN + 1):
        lo, hi = max(1, p - NN), min(MM, p - 1)
        i = rows[lo:hi + 1]
        m2, m1 = ring[(p - 2) % 3], ring[(p - 1) % 3]
        v = scheme(m2[:, lo - 1:hi], m1[:, lo - 1:hi], m1[:, lo:hi + 1],
                   flat[:, i - 1, p - 1 - i])
        ring[p % 3][:, lo:hi + 1] = v
        if bd is not None:
            if p <= NN:
                ring[p % 3][:, 0] = bd[:, p]
            if hi == MM:
                bottom[:, p - MM] = v[:, -1]
        if grid is not None:
            grid[:, i, p - i] = v
    final = ring[(MM + NN) % 3][:, MM].reshape(batch)
    if grid is not None:
        grid = grid.reshape(*batch, MM + 1, NN + 1)
    if bottom is not None:
        bottom = bottom.reshape(*batch, NN + 1)
    return final, grid, bottom


def solve_final(inc: torch.Tensor, naive: bool = False) -> torch.Tensor:
    """Solve the Goursat PDE; return only the final corner ``K[..., -1, -1]``."""
    return _sweep(inc, naive, return_grid=False)[0]


def solve_grid(inc: torch.Tensor, naive: bool = False) -> torch.Tensor:
    """Solve the Goursat PDE; return the full ``(..., MM+1, NN+1)`` grid."""
    return _sweep(inc, naive, return_grid=True)[1]


def solve_stripe(inc: torch.Tensor, bd: torch.Tensor,
                 naive: bool = False) -> torch.Tensor:
    """Sweep one horizontal stripe from a general north boundary
    (:func:`sigkernel_tpu.ops.scan_solver.solve_stripe`).

    ``inc``: ``(..., MMs, NN)`` stripe increments; ``bd``: ``(..., NN+1)``
    the north boundary row ``K[0_local, :]``, the bottom row of the stripe
    above (``bd[..., 0] == 1``, the west corner). Returns the stripe's
    bottom row ``K[MMs, :]`` as ``(..., NN+1)``; the last stripe's entry
    ``[..., NN]`` is the solve's corner. The plain version of K7.
    """
    return _sweep(inc, naive, return_grid=False, bd=bd)[2]


def solve_stripe_grid(inc: torch.Tensor, bd: torch.Tensor,
                      naive: bool = False) -> torch.Tensor:
    """The stripe's full ``(..., MMs+1, NN+1)`` grid, row 0 = ``bd`` (the
    plain counterpart of JAX ``pallas_blocked._stripe_grid``, and of
    K7-stack through :func:`grid_to_stack`)."""
    return _sweep(inc, naive, return_grid=True, bd=bd)[1]


# ---------------------------------------------------------------------------
# The triple sweep of the derivative Gram: (K, K_diff, K_diffdiff)
# ---------------------------------------------------------------------------


def derivative_cell(nw, n, w, inc):
    """One cell of the triple sweep: ``(K, K_diff, K_diffdiff)`` from the
    triples of its north-west, north and west neighbours and its three
    increments ``(u, ud, us)``, each unpacked along its first axis. ``K``
    takes the order-2 scheme, the derivatives the product-rule recurrences
    f1..f4 / g1..g4 in this op order (K5 rounds as this does)."""
    (k00, d00, s00), (k01, d01, s01), (k10, d10, s10) = nw, n, w
    u, ud, us = inc
    k = _update_order2(k00, k01, k10, u)

    f1 = k00 * ud + d00 * u
    f2 = k01 * ud + d01 * u
    f3 = k10 * ud + d10 * u
    dsum = d01 + d10 - d00
    f4 = k * ud + (dsum + f1) * u
    d = dsum + 0.25 * (f1 + f2 + f3 + f4)

    g1 = k00 * us + 2.0 * d00 * ud + s00 * u
    g2 = k01 * us + 2.0 * d01 * ud + s01 * u
    g3 = k10 * us + 2.0 * d10 * ud + s10 * u
    ssum = s01 + s10 - s00
    g4 = k * us + 2.0 * d * ud + (ssum + g1) * u
    s = ssum + 0.25 * (g1 + g2 + g3 + g4)
    return k, d, s


def solve_derivatives_final(inc: torch.Tensor, inc_d: torch.Tensor,
                            inc_dd: torch.Tensor):
    """Sweep ``(K, K_diff, K_diffdiff)`` over refined increment grids
    ``(..., MM, NN)`` of the kernel and its first and second directional
    derivatives; returns the three corners, each with the batch shape.

    Each cell is :func:`derivative_cell`, the recurrences of
    :func:`sigkernel_tpu.ops.scan_solver.solve_derivatives_final` in its op
    order (the K5 kernel rounds as this loop does). Boundary ``K = 1``,
    ``K_diff = K_diffdiff = 0``; a length-1 path gives ``(1, 0, 0)``. Each
    diagonal is a new tensor (no in-place update), so autograd
    differentiates the loop.
    """
    *batch, MM, NN = inc.shape
    if MM == 0 or NN == 0:
        return inc.new_ones(batch), inc.new_zeros(batch), inc.new_zeros(batch)
    B = math.prod(batch)
    flat = [t.reshape(B, MM, NN) for t in (inc, inc_d, inc_dd)]
    one, zero = inc.new_ones(B, MM + 1), inc.new_zeros(B, MM + 1)
    # diagonals p - 2 and p - 1 of each state, rows 0..MM
    k2 = k1 = one
    d2 = d1 = s2 = s1 = zero
    rows = torch.arange(MM + 1, device=inc.device)
    for p in range(2, MM + NN + 1):
        lo, hi = max(1, p - NN), min(MM, p - 1)
        i = rows[lo:hi + 1]
        k, d, s = derivative_cell(
            (k2[:, lo - 1:hi], d2[:, lo - 1:hi], s2[:, lo - 1:hi]),
            (k1[:, lo - 1:hi], d1[:, lo - 1:hi], s1[:, lo - 1:hi]),
            (k1[:, lo:hi + 1], d1[:, lo:hi + 1], s1[:, lo:hi + 1]),
            [g[:, i - 1, p - 1 - i] for g in flat])

        # rows outside lo..hi: the boundary values (row 0 and row p are
        # the grid's boundary; the others are never read)
        k2, k1 = k1, torch.cat([one[:, :lo], k, one[:, hi + 1:]], dim=1)
        d2, d1 = d1, torch.cat([zero[:, :lo], d, zero[:, hi + 1:]], dim=1)
        s2, s1 = s1, torch.cat([zero[:, :lo], s, zero[:, hi + 1:]], dim=1)
    return tuple(t[:, MM].reshape(batch) for t in (k1, d1, s1))


# ---------------------------------------------------------------------------
# The adjoint's plain pieces (the kernels' layout and order, in torch)
# ---------------------------------------------------------------------------
#
# The kernels solve in a frame whose rows are the shorter refined side: the
# grid is transposed when MM > NN. Their forward stack is diagonal-major in
# that frame, ``stack[..., p, i] = K[i, p - i]`` (0 outside the grid), of
# shape ``(..., R + C + 1, R + 1)`` with ``R = min(MM, NN)``,
# ``C = max(MM, NN)`` (see ``csrc/wavefront.cuh``).


def _frame(grid: torch.Tensor, transpose: bool) -> torch.Tensor:
    return grid.transpose(-1, -2) if transpose else grid


def grid_to_stack(grid: torch.Tensor) -> torch.Tensor:
    """A ``(..., MM+1, NN+1)`` solution grid as the kernels' stack."""
    MM, NN = grid.shape[-2] - 1, grid.shape[-1] - 1
    g = _frame(grid, MM > NN)
    R, C = g.shape[-2] - 1, g.shape[-1] - 1
    p = torch.arange(R + C + 1, device=grid.device)[:, None]
    i = torch.arange(R + 1, device=grid.device)[None, :]
    j = p - i
    vals = g[..., i.expand_as(j), j.clamp(0, C)]
    return torch.where((j >= 0) & (j <= C), vals, torch.zeros_like(vals))


def stack_to_grid(stack: torch.Tensor, MM: int, NN: int) -> torch.Tensor:
    """The kernels' stack back to the ``(..., MM+1, NN+1)`` grid."""
    transpose = MM > NN
    R, C = (NN, MM) if transpose else (MM, NN)
    i = torch.arange(R + 1, device=stack.device)[:, None]
    j = torch.arange(C + 1, device=stack.device)[None, :]
    return _frame(stack[..., i + j, i.expand(R + 1, C + 1)], transpose)


def collapse_refined(KK: torch.Tensor, f: int) -> torch.Tensor:
    """Sum each ``f x f`` block of a refined ``(..., MM, NN)`` grid ->
    ``(..., MM/f, NN/f)``, unscaled.

    The terms of a block are added one at a time in the adjoint kernel's
    order (``csrc/adjoint_collapse.cu``): in the frame whose rows are the
    shorter side, by anti-diagonal ``k + l`` descending, then row ``k``
    ascending. So this and the kernel agree bit for bit.
    """
    transpose = KK.shape[-2] > KK.shape[-1]
    KK = _frame(KK, transpose)
    *batch, R, C = KK.shape
    blocks = KK.reshape(*batch, R // f, f, C // f, f)
    acc = KK.new_zeros(*batch, R // f, C // f)
    for d in range(2 * f - 2, -1, -1):
        for k in range(max(0, d - f + 1), min(f - 1, d) + 1):
            acc = acc + blocks[..., :, k, :, d - k]
    return _frame(acc, transpose)


def flip2(x: torch.Tensor) -> torch.Tensor:
    """Reverse both trailing axes."""
    return torch.flip(x, dims=(-2, -1))


def product_collapse(grid: torch.Tensor, grid_rev: torch.Tensor,
                     f: int) -> torch.Tensor:
    """The adjoint's product and collapse: with ``grid`` the forward and
    ``grid_rev`` the reverse solution (increments flipped along both axes),
    ``KK[i, j] = K[i, j] * K_rev[MM-1-i, NN-1-j]`` is the corner's gradient
    in the refined increment ``(i, j)``; the result is its ``f x f`` block
    sums over ``f^2`` (the VJP of the dyadic refinement), at base
    resolution."""
    KK = grid[..., :-1, :-1] * flip2(grid_rev)[..., 1:, 1:]
    return collapse_refined(KK, f) / (f * f)


def adjoint_from_stack(inc_refined: torch.Tensor, stack: torch.Tensor,
                       f: int, naive: bool = False) -> torch.Tensor:
    """The plain version of the adjoint kernel K3: the forward solution
    from its stack, the reverse solve of the flipped refined increments,
    then :func:`product_collapse` -> ``(..., MM/f, NN/f)``."""
    MM, NN = inc_refined.shape[-2:]
    grid = stack_to_grid(stack, MM, NN)
    return product_collapse(grid, solve_grid(flip2(inc_refined), naive), f)


# ---------------------------------------------------------------------------
# The sparse stack of the checkpoint adjoint (K2-sparse, K8)
# ---------------------------------------------------------------------------
#
# At window W >= 2 the sparse stack keeps the full stack's rows whose
# diagonal p has p % W < 2: pair w is diagonals (w W, w W + 1) at rows
# (2 w, 2 w + 1), for the ckpt_pairs windows that the adjoint's diagonals
# 0 .. R + C - 2 touch (``csrc/wavefront.cuh``).


def ckpt_pairs(R: int, C: int, W: int) -> int:
    """Stored diagonal pairs of the sparse stack of an ``R x C`` frame."""
    return (R + C - 2) // W + 1


def sparse_rows(R: int, C: int, W: int) -> list:
    """The full stack's rows that the sparse stack keeps, in its order."""
    return [w * W + k for w in range(ckpt_pairs(R, C, W)) for k in (0, 1)]


def stack_to_sparse(stack: torch.Tensor, W: int) -> torch.Tensor:
    """The sparse stack: the checkpoint rows of a full ``(..., R + C + 1,
    R + 1)`` stack."""
    R = stack.shape[-1] - 1
    C = stack.shape[-2] - 1 - R
    return stack[..., sparse_rows(R, C, W), :]


def sparse_to_stack(sparse: torch.Tensor, inc_refined: torch.Tensor, W: int,
                    naive: bool = False) -> torch.Tensor:
    """The full stack rebuilt from the sparse one: the diagonals between
    the stored pairs are swept again from the nearest pair below, in the
    forward's op order, from the refined increments ``(..., MM, NN)``. The
    plain version of K8's in-kernel recompute."""
    MM, NN = inc_refined.shape[-2:]
    u = _frame(inc_refined, MM > NN)
    R, C = u.shape[-2:]
    scheme = get_scheme(naive)
    stack = u.new_zeros(*u.shape[:-2], R + C + 1, R + 1)
    rows = torch.arange(R + 1, device=u.device)
    last = ckpt_pairs(R, C, W) - 1
    for d in range(R + C + 1):
        w, k = divmod(d, W)
        if k < 2 and w <= last:
            stack[..., d, :] = sparse[..., 2 * w + k, :]
            continue
        lo, hi = max(1, d - C), min(R, d - 1)
        i = rows[lo:hi + 1]
        m1, m2 = stack[..., d - 1, :], stack[..., d - 2, :]
        row = ((rows >= d - C) & (rows <= d)).to(u.dtype).expand_as(m1)
        row = row.clone()
        row[..., lo:hi + 1] = scheme(m2[..., lo - 1:hi], m1[..., lo - 1:hi],
                                     m1[..., lo:hi + 1], u[..., i - 1,
                                                            d - 1 - i])
        stack[..., d, :] = row
    return stack
