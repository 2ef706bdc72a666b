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

K2-sparse (:func:`inc_solve_sparse`) writes only the sparse stack, two of
every :data:`CKPT_WINDOW` diagonals (the ckpt output of
``pallas_df64.py``'s ``_wavefront_df_kernel``), and K8
(:func:`inc_adjoint_ckpt`, ``csrc/adjoint_ckpt.cu``) replaces
``pallas_adjoint.py``'s ``_product_ckpt_kernel``: K3<inc> with the skipped
forward diagonals recomputed in-kernel, window by window, bit for bit as
the forward computed them. The pair serves the backward when full stacks
would not fill the card (``routes.resolve_inc_tier``).

Each wrapper launches its kernel for CUDA tensors and takes its plain
version (``*_plain``) only for CPU tensors. ``COUNTS``, ``STACK_COUNTS``,
``ADJOINT_COUNTS``, ``SPARSE_COUNTS`` and ``CKPT_COUNTS`` hold the kernel
launches per dtype and the calls of the plain versions.
"""
from __future__ import annotations

import torch

from . import _build, scan_solver
from ..utils import dyadic_refine

COUNTS = {"float32": 0, "float64": 0, "plain": 0}
STACK_COUNTS = {"float32": 0, "float64": 0, "plain": 0}
ADJOINT_COUNTS = {"float32": 0, "float64": 0, "plain": 0}
SPARSE_COUNTS = {"float32": 0, "float64": 0, "plain": 0}
CKPT_COUNTS = {"float32": 0, "float64": 0, "plain": 0}

# K8's window: diagonals between stored pairs, at least 2. The sparse stack
# is W / 2 times smaller than the full one; K8's per-block scratch of W
# diagonals stays in L2 for one wave (csrc/adjoint_ckpt.cu). Read at call
# time.
CKPT_WINDOW = 8

_FNS = {torch.float32: "sk_inc_wavefront_f32",
        torch.float64: "sk_inc_wavefront_f64"}
_STACK_FNS = {torch.float32: "sk_inc_stack_f32",
              torch.float64: "sk_inc_stack_f64"}
_ADJOINT_FNS = {torch.float32: "sk_adjoint_inc_f32",
                torch.float64: "sk_adjoint_inc_f64"}
_SPARSE_FNS = {torch.float32: "sk_inc_sparse_f32",
               torch.float64: "sk_inc_sparse_f64"}
_CKPT_FNS = {torch.float32: "sk_adjoint_ckpt_f32",
             torch.float64: "sk_adjoint_ckpt_f64"}


def stack_shape(P: int, MM: int, NN: int):
    """The stack of ``P`` refined ``MM x NN`` grids: ``(P, R + C + 1,
    R + 1)`` with ``R`` the shorter side (``csrc/wavefront.cuh``)."""
    R, C = min(MM, NN), max(MM, NN)
    return (P, R + C + 1, R + 1)


def window() -> int:
    """:data:`CKPT_WINDOW`, checked. Any grid with both sides at least 1
    has a sparse stack at any window of 2 or more diagonals: JAX's ``f in
    (2, 4)`` and first-window conditions (``ckpt_supported``) came from its
    residue algebra on lane windows; this layout needs neither."""
    if CKPT_WINDOW < 2:
        raise ValueError("the sparse stack's window must hold at least 2 "
                         f"diagonals; CKPT_WINDOW is {CKPT_WINDOW}")
    return CKPT_WINDOW


def sparse_shape(P: int, MM: int, NN: int):
    """The sparse stack of ``P`` refined ``MM x NN`` grids:
    ``(P, 2 ckpt_pairs, R + 1)`` (``csrc/wavefront.cuh``)."""
    R, C = min(MM, NN), max(MM, NN)
    return (P, 2 * scan_solver.ckpt_pairs(R, C, window()), R + 1)


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


def inc_solve_sparse_plain(inc: torch.Tensor, dyadic_order: int = 0,
                           naive: bool = False):
    """Plain version of K2-sparse: the plain grid's stack, checkpoint rows
    only (:func:`.scan_solver.stack_to_sparse`)."""
    SPARSE_COUNTS["plain"] += 1
    grid = scan_solver.solve_grid(dyadic_refine(inc, dyadic_order), naive)
    return (grid[..., -1, -1].clone(),
            scan_solver.stack_to_sparse(scan_solver.grid_to_stack(grid),
                                        window()))


def inc_adjoint_ckpt_plain(inc: torch.Tensor, sparse: torch.Tensor,
                           dyadic_order: int = 0,
                           naive: bool = False) -> torch.Tensor:
    """Plain version of K8: the full stack rebuilt window by window
    (:func:`.scan_solver.sparse_to_stack`), then the plain adjoint."""
    CKPT_COUNTS["plain"] += 1
    ref = dyadic_refine(inc, dyadic_order)
    stack = scan_solver.sparse_to_stack(sparse, ref, window(), naive)
    return scan_solver.adjoint_from_stack(ref, stack, 2 ** dyadic_order,
                                          naive)


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


def inc_solve_sparse(inc: torch.Tensor, dyadic_order: int = 0,
                     naive: bool = False):
    """K2-sparse: ``(values (P,), sparse stack)`` of a ``(P, Mb, Nb)`` base
    grid at the window :data:`CKPT_WINDOW`; the sparse stack's shape is
    :func:`sparse_shape`. Needs ``Mb, Nb >= 1`` on the card."""
    if inc.device.type == "cpu":
        return inc_solve_sparse_plain(inc, dyadic_order, naive)
    _check(inc, "inc_solve_sparse")
    W = window()
    P, Mb, Nb = inc.shape
    if Mb == 0 or Nb == 0:
        raise ValueError("inc_solve_sparse: a length-1 path has no stack")
    f = 2 ** dyadic_order
    _build.check_rows(min(Mb, Nb) * f, inc.element_size(), "inc_solve_sparse")
    out = torch.empty(P, dtype=inc.dtype, device=inc.device)
    sparse = torch.empty(sparse_shape(P, Mb * f, Nb * f), dtype=inc.dtype,
                         device=inc.device)
    if P:
        _build.launch("inc_sparse", _SPARSE_FNS, SPARSE_COUNTS, inc,
                      inc.data_ptr(), out.data_ptr(), sparse.data_ptr(), P,
                      Mb, Nb, f, W, int(naive))
    return out, sparse


def inc_adjoint_ckpt(inc: torch.Tensor, sparse: torch.Tensor,
                     dyadic_order: int = 0,
                     naive: bool = False) -> torch.Tensor:
    """K8: the gradient ``(P, Mb, Nb)`` of each pair's corner in its base
    increments from the sparse stack of :func:`inc_solve_sparse` (at the
    same :data:`CKPT_WINDOW`); equal to :func:`inc_adjoint` on the full
    stack, bit for bit."""
    if inc.device.type == "cpu":
        return inc_adjoint_ckpt_plain(inc, sparse, dyadic_order, naive)
    _check(inc, "inc_adjoint_ckpt")
    W = window()
    P, Mb, Nb = inc.shape
    f = 2 ** dyadic_order
    if Mb == 0 or Nb == 0 or P == 0:
        return torch.zeros_like(inc)
    R = min(Mb, Nb) * f
    _build.check_rows(R, inc.element_size(), "inc_adjoint_ckpt")
    want = sparse_shape(P, Mb * f, Nb * f)
    if (sparse.shape != want or sparse.dtype != inc.dtype
            or sparse.device != inc.device or not sparse.is_contiguous()):
        raise ValueError(f"inc_adjoint_ckpt: the sparse stack must be a "
                         f"contiguous {want} tensor of the grid's dtype and "
                         "device")
    ct = torch.zeros_like(inc)
    scratch = torch.empty(P, W, R + 1, dtype=inc.dtype, device=inc.device)
    _build.launch("adjoint_ckpt", _CKPT_FNS, CKPT_COUNTS, inc, inc.data_ptr(),
                  sparse.data_ptr(), scratch.data_ptr(), ct.data_ptr(), P,
                  Mb, Nb, f, W, int(naive))
    return ct / (f * f)
