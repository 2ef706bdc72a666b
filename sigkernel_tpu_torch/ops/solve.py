"""Differentiable Goursat solve on a base increment grid.

Counterpart of :func:`sigkernel_tpu.ops.solve.solve`: ``inc`` of shape
``(..., M-1, N-1)`` is refined by ``2^dyadic_order`` inside the solver and
the corner ``K[..., -1, -1]`` comes back with the batch shape of ``inc``. A
length-1 path gives a ``(..., 0, N-1)`` grid, whose solution is the boundary
value 1.

Gradients come from the adjoint PDE, as in JAX (``solve.py:130-297``): a
second sweep over the increments flipped along both axes, whose product with
the forward solution, collapsed to the base grid, is the gradient
(:func:`.scan_solver.product_collapse`). Never autograd through the loop:
that would be the derivative of the discrete scheme, another number. The
route (:func:`.routes.resolve`, then :func:`.routes.resolve_inc_tier` by
shape) picks, for both halves of :class:`_Solve`:

- ``inc`` (CUDA): forward K2, or K7 stripes (:mod:`.cuda_blocked`) past the
  row bound; backward, in chunks of pairs whose stacks fit
  :data:`.routes.STACK_BYTES`, in the grade's dtype: K2-stack + K3<inc>
  while a chunk holds at least :data:`.routes.CKPT_MIN_PAIRS` full stacks,
  else K2-sparse + K8, and the striped adjoint past the row bound;
- ``scan``: the plain loop; backward :func:`grid_route_bwd`, one plain grid
  sweep over ``[inc; flip2(inc)]``.
"""
from __future__ import annotations

import math

import torch

from . import cuda_blocked, cuda_solver, routes, scan_solver
from ..tracing import span
from ..utils import dyadic_refine


def grid_route_bwd(inc: torch.Tensor, g: torch.Tensor, naive: bool,
                   dyadic_order: int) -> torch.Tensor:
    """The plain adjoint (JAX ``_grid_route_bwd``): one grid sweep over
    ``[inc; flip2(inc)]`` refined, the product, the collapse, times ``g``
    -> ``(B, Mb, Nb)`` in ``inc``'s dtype."""
    B = inc.shape[0]
    ref = dyadic_refine(inc, dyadic_order)
    both = scan_solver.solve_grid(torch.cat([ref, scan_solver.flip2(ref)]),
                                  naive)
    ct = scan_solver.product_collapse(both[:B], both[B:], 2 ** dyadic_order)
    return ct * g.to(ct.dtype)[:, None, None]


def inc_route_bwd(inc: torch.Tensor, g: torch.Tensor, naive: bool,
                  dyadic_order: int) -> torch.Tensor:
    """The CUDA adjoint, times ``g`` -> ``(B, Mb, Nb)`` in ``inc``'s dtype,
    chunk by chunk on the tier :func:`.routes.resolve_inc_tier` gives:
    K2-stack then K3<inc> (``full``), K2-sparse then K8 (``ckpt``), or the
    striped adjoint (:func:`.cuda_blocked.adjoint`)."""
    P, Mb, Nb = inc.shape
    out = torch.zeros_like(inc)
    if Mb == 0 or Nb == 0:
        return out
    f = 2 ** dyadic_order
    MM, NN, size = Mb * f, Nb * f, inc.element_size()
    tier = routes.resolve_inc_tier((MM, NN), size, backward=True)
    chunk = routes.chunk_pairs(P, routes.tier_bytes(tier, (MM, NN), size))
    for s in range(0, P, chunk):
        with span("sk.est.chunk"):
            c = inc[s:s + chunk].contiguous()
            if tier == "full":
                _, stack = cuda_solver.inc_solve_stack(c, dyadic_order, naive)
                ct = cuda_solver.inc_adjoint(c, stack, dyadic_order, naive)
                del stack
            elif tier == "ckpt":
                _, sparse = cuda_solver.inc_solve_sparse(c, dyadic_order,
                                                         naive)
                ct = cuda_solver.inc_adjoint_ckpt(c, sparse, dyadic_order,
                                                  naive)
                del sparse
            else:
                ct = cuda_blocked.adjoint(c, dyadic_order, naive)
            out[s:s + chunk] = ct * g[s:s + chunk, None, None].to(ct.dtype)
    return out


def inc_route_fwd(inc: torch.Tensor, naive: bool,
                  dyadic_order: int) -> torch.Tensor:
    """The CUDA forward: K2 within the row bound, K7 stripes past it."""
    f = 2 ** dyadic_order
    shape = (inc.shape[-2] * f, inc.shape[-1] * f)
    if routes.resolve_inc_tier(shape, inc.element_size()) == "stripes":
        return cuda_blocked.solve_final(inc, dyadic_order, naive)
    return cuda_solver.inc_solve_final(inc, dyadic_order, naive)


class _Solve(torch.autograd.Function):
    """``inc (B, Mb, Nb) -> K[:, -1, -1]`` with the adjoint-PDE backward."""

    @staticmethod
    def forward(ctx, inc, naive, solver, dyadic_order, grad_solver):
        route = routes.resolve(None, inc.device.type, solver, inc.dtype,
                               grad_solver)
        ctx.save_for_backward(inc)
        ctx.cfg = (naive, solver, dyadic_order, grad_solver)
        if route.family == "inc":
            return inc_route_fwd(inc.contiguous(), naive, dyadic_order)
        return scan_solver.solve_final(dyadic_refine(inc, dyadic_order),
                                       naive)

    @staticmethod
    def backward(ctx, g):
        (inc,) = ctx.saved_tensors
        naive, solver, dyadic_order, grad_solver = ctx.cfg
        route = routes.resolve(None, inc.device.type, solver, inc.dtype,
                               grad_solver)
        if route.family == "inc":
            ct = inc_route_bwd(inc.to(route.bwd_dtype), g, naive,
                               dyadic_order)
        else:
            ct = grid_route_bwd(inc, g, naive, dyadic_order)
        return ct.to(inc.dtype), None, None, None, None


def solve(inc: torch.Tensor, naive: bool = False, solver: str = "auto",
          dyadic_order: int = 0, grad_solver: str = "auto") -> torch.Tensor:
    """``K[..., -1, -1]`` of each base increment grid; differentiable in
    ``inc`` through the adjoint PDE."""
    batch_shape = inc.shape[:-2]
    # explicit batch size: -1 cannot be inferred when a trailing dim is 0
    flat = inc.reshape((math.prod(batch_shape),) + tuple(inc.shape[-2:]))
    out = _Solve.apply(flat, naive, solver, dyadic_order, grad_solver)
    return out.reshape(batch_shape)
