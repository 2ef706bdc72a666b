"""Forward Goursat solve on a base increment grid.

Counterpart of the value path of :func:`sigkernel_tpu.ops.solve.solve`:
``inc`` of shape ``(..., M-1, N-1)`` is refined by ``2^dyadic_order`` inside
the solver and the corner ``K[..., -1, -1]`` comes back with the batch shape
of ``inc``. The route (K2 on the card, or the plain loop) comes from
:func:`.routes.resolve_family`. A length-1 path gives a ``(..., 0, N-1)``
grid, whose solution is the boundary value 1.
"""
from __future__ import annotations

import math

import torch

from . import cuda_solver, routes, scan_solver
from ..utils import dyadic_refine


def solve(inc: torch.Tensor, naive: bool = False, solver: str = "auto",
          dyadic_order: int = 0) -> torch.Tensor:
    batch_shape = inc.shape[:-2]
    # explicit batch size: -1 cannot be inferred when a trailing dim is 0
    flat = inc.reshape((math.prod(batch_shape),) + tuple(inc.shape[-2:]))
    if routes.resolve_family(None, inc.device.type, solver) == "inc":
        out = cuda_solver.inc_solve_final(flat.contiguous(), dyadic_order,
                                          naive)
    else:
        out = scan_solver.solve_final(dyadic_refine(flat, dyadic_order),
                                      naive)
    return out.reshape(batch_shape)
