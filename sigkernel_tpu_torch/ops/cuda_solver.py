"""K2: the increment-grid wavefront (``csrc/inc_wavefront.cu``), its
stack-emitting instance, and K3<inc>, the adjoint over the same grid
(``csrc/adjoint_collapse.cu``).

K2 replaces the value path of ``sigkernel_tpu/ops/pallas_solver.py``
(``_wavefront_kernel``, ``_wavefront_f32_planes_kernel``) and of
``sigkernel_tpu/ops/pallas_df64.py`` (``_wavefront_df_kernel``,
``_wavefront_df_planes_kernel``): the corner ``K[MM, NN]`` of each pair's
Goursat solve over a base increment grid ``(P, Mb, Nb)`` refined by
``2^dyadic_order`` in the kernel. One block per pair; the ring of three
anti-diagonals of the shorter refined side lives in shared memory. On the
H100 it is bound by reading the increment grid from device memory; the
kernel reads it at base resolution and never builds the refined grid.

K2-stack (:func:`inc_solve_stack`) also writes the solution stack, the
grid/stack outputs of those TPU kernels. K3<inc> (:func:`inc_adjoint`)
replaces ``pallas_adjoint.py``'s ``_product_kernel``,
``_product_collapse_kernel`` and ``_product_collapse_planes_kernel``: the
reverse sweep, its product with the stack, and the dyadic collapse, giving
the base-resolution gradient of each corner in its increments.

Each wrapper launches its kernel for CUDA tensors and takes its plain
version (``*_plain``) only for CPU tensors. ``COUNTS``, ``STACK_COUNTS`` and
``ADJOINT_COUNTS`` hold the kernel launches per dtype and the calls of the
plain versions.
"""
from __future__ import annotations

import torch

from . import _build, scan_solver
from ..utils import dyadic_refine

COUNTS = {"float32": 0, "float64": 0, "plain": 0}
STACK_COUNTS = {"float32": 0, "float64": 0, "plain": 0}
ADJOINT_COUNTS = {"float32": 0, "float64": 0, "plain": 0}

_FNS = {torch.float32: "sk_inc_wavefront_f32",
        torch.float64: "sk_inc_wavefront_f64"}
_STACK_FNS = {torch.float32: "sk_inc_stack_f32",
              torch.float64: "sk_inc_stack_f64"}
_ADJOINT_FNS = {torch.float32: "sk_adjoint_inc_f32",
                torch.float64: "sk_adjoint_inc_f64"}


def stack_shape(P: int, MM: int, NN: int):
    """The stack of ``P`` refined ``MM x NN`` grids: ``(P, R + C + 1,
    R + 1)`` with ``R`` the shorter side (``csrc/wavefront.cuh``)."""
    R, C = min(MM, NN), max(MM, NN)
    return (P, R + C + 1, R + 1)


def inc_solve_final_plain(inc: torch.Tensor, dyadic_order: int = 0,
                          naive: bool = False) -> torch.Tensor:
    """Plain version: refine the grid, then the plain anti-diagonal loop."""
    COUNTS["plain"] += 1
    return scan_solver.solve_final(dyadic_refine(inc, dyadic_order), naive)


def inc_solve_stack_plain(inc: torch.Tensor, dyadic_order: int = 0,
                          naive: bool = False):
    """Plain version of K2-stack: the plain grid, laid out as the stack."""
    STACK_COUNTS["plain"] += 1
    grid = scan_solver.solve_grid(dyadic_refine(inc, dyadic_order), naive)
    # clone: a view of the corner would keep the whole grid alive
    return grid[..., -1, -1].clone(), scan_solver.grid_to_stack(grid)


def inc_adjoint_plain(inc: torch.Tensor, stack: torch.Tensor,
                      dyadic_order: int = 0,
                      naive: bool = False) -> torch.Tensor:
    """Plain version of K3<inc>: :func:`.scan_solver.adjoint_from_stack`."""
    ADJOINT_COUNTS["plain"] += 1
    return scan_solver.adjoint_from_stack(dyadic_refine(inc, dyadic_order),
                                          stack, 2 ** dyadic_order, naive)


def _check(inc: torch.Tensor, what: str) -> None:
    if inc.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {inc.device}")
    if inc.dtype not in _FNS:
        raise ValueError(f"{what}: dtype {inc.dtype}; expected "
                         "torch.float32 or torch.float64")
    if inc.dim() != 3:
        raise ValueError(f"{what}: expected (P, Mb, Nb); got shape "
                         f"{tuple(inc.shape)}")
    if not inc.is_contiguous():
        raise ValueError(f"{what}: the increment grid must be contiguous")
    if inc.shape[0] >= 2 ** 31:
        raise ValueError(f"{what}: {inc.shape[0]} pairs exceed one launch")


def inc_solve_final(inc: torch.Tensor, dyadic_order: int = 0,
                    naive: bool = False) -> torch.Tensor:
    """``K[MM, NN]`` for each pair of a ``(P, Mb, Nb)`` base increment grid."""
    if inc.device.type == "cpu":
        return inc_solve_final_plain(inc, dyadic_order, naive)
    _check(inc, "inc_solve_final")
    P, Mb, Nb = inc.shape
    if P == 0 or Mb == 0 or Nb == 0:
        # no pairs, or a length-1 path (K is its boundary, 1): no launch
        return inc.new_ones(P)
    f = 2 ** dyadic_order
    _build.check_rows(min(Mb, Nb) * f, inc.element_size(), "inc_solve_final")
    out = torch.empty(P, dtype=inc.dtype, device=inc.device)
    _build.launch("inc_wavefront", _FNS, COUNTS, inc, inc.data_ptr(),
                  out.data_ptr(), P, Mb, Nb, f, int(naive))
    return out


def inc_solve_stack(inc: torch.Tensor, dyadic_order: int = 0,
                    naive: bool = False):
    """K2-stack: ``(values (P,), stack)`` of a ``(P, Mb, Nb)`` base grid;
    the stack's shape is :func:`stack_shape` of the refined grid. Needs
    ``Mb, Nb >= 1`` on the card (a length-1 path has no adjoint to feed)."""
    if inc.device.type == "cpu":
        return inc_solve_stack_plain(inc, dyadic_order, naive)
    _check(inc, "inc_solve_stack")
    P, Mb, Nb = inc.shape
    if Mb == 0 or Nb == 0:
        raise ValueError("inc_solve_stack: a length-1 path has no stack")
    f = 2 ** dyadic_order
    _build.check_rows(min(Mb, Nb) * f, inc.element_size(), "inc_solve_stack")
    out = torch.empty(P, dtype=inc.dtype, device=inc.device)
    stack = torch.empty(stack_shape(P, Mb * f, Nb * f), dtype=inc.dtype,
                        device=inc.device)
    if P:
        _build.launch("inc_stack", _STACK_FNS, STACK_COUNTS, inc,
                      inc.data_ptr(), out.data_ptr(), stack.data_ptr(), P, Mb,
                      Nb, f, int(naive))
    return out, stack


def inc_adjoint(inc: torch.Tensor, stack: torch.Tensor,
                dyadic_order: int = 0, naive: bool = False) -> torch.Tensor:
    """K3<inc>: the gradient ``(P, Mb, Nb)`` of each pair's corner in its
    base increments, given the forward ``stack`` of :func:`inc_solve_stack`
    (unit upstream cotangent; the caller scales by its ``g``)."""
    if inc.device.type == "cpu":
        return inc_adjoint_plain(inc, stack, dyadic_order, naive)
    _check(inc, "inc_adjoint")
    P, Mb, Nb = inc.shape
    f = 2 ** dyadic_order
    if Mb == 0 or Nb == 0 or P == 0:
        return torch.zeros_like(inc)
    _build.check_rows(min(Mb, Nb) * f, inc.element_size(), "inc_adjoint")
    if (stack.shape != stack_shape(P, Mb * f, Nb * f)
            or stack.dtype != inc.dtype or stack.device != inc.device
            or not stack.is_contiguous()):
        raise ValueError("inc_adjoint: stack must be a contiguous "
                         f"{stack_shape(P, Mb * f, Nb * f)} tensor of the "
                         "grid's dtype and device")
    ct = torch.zeros_like(inc)
    _build.launch("adjoint_collapse_inc", _ADJOINT_FNS, ADJOINT_COUNTS, inc,
                  inc.data_ptr(), stack.data_ptr(), ct.data_ptr(), P, Mb, Nb,
                  f, int(naive))
    return ct / (f * f)
