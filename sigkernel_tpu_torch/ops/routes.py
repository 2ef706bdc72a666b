"""The one route resolver of the port, for both halves of every autograd
Function.

Every decision about which solver a tile takes, and in which dtype its
gradient is computed, goes through :func:`resolve` (its family part is
:func:`resolve_family`), so the whole matrix is enumerable in one place
(``tests/test_torch_routes.py``). It takes the device *type string*, so the
CPU tests pin the CUDA rows too. Callers reach it through this module object
(``routes.resolve_family``, ``routes.resolve``), so a test can steer the
route by patching it; a Function's forward and backward both call it.

========  =====================================  ==========================
family    computation                            kernels (forward; adjoint)
========  =====================================  ==========================
``gen``   RBF increments generated in-kernel     K1 ``cuda_gen``; K1-stack,
                                                 K3<gen>, K4 ``incvjp``
``lgen``  Linear increments generated in-kernel  K6 ``cuda_lgen``; K2-stack,
                                                 K3<inc> on the recomputed
                                                 grid
``inc``   ``double_difference(Gram)`` in torch   K2 ``cuda_solver``;
                                                 K2-stack, K3<inc>
``scan``  the same increments, plain loop        none (``scan_solver``)
========  =====================================  ==========================

The derivative Gram (:func:`resolve_derivatives`) has its own two routes:
``cuda``, K5 ``cuda_deriv`` (forward only), and ``scan``, the plain triple
sweep, which autograd differentiates.

The backward's dtype (``grad_solver``): ``"auto"`` and ``"df64"`` give
gradients at the input precision (on Hopper, ``df64`` is native double);
``"f32"`` runs the kernel chain in float32 and casts the gradients back to
the input dtype. The ``scan`` family ignores the grade: its gradients are at
the input precision, as the JAX scan tier's are.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels as _kernels

SOLVERS = ("auto", "scan", "cuda")
FAMILIES = ("gen", "lgen", "inc", "scan")
DERIV_ROUTES = ("cuda", "scan")
GRAD_SOLVERS = ("auto", "f32", "df64")


class Route(NamedTuple):
    family: str
    bwd_dtype: torch.dtype


def check_grad_solver(grad_solver: str) -> None:
    if grad_solver not in GRAD_SOLVERS:
        raise ValueError(f"unknown grad_solver {grad_solver!r}; expected one "
                         f"of {GRAD_SOLVERS}")


def _plain_tier(device_type: str, solver: str) -> bool:
    """Does this call take the plain tier? ``solver="scan"`` on any device
    (an explicit choice); ``"auto"`` off CUDA; ``"cuda"`` off CUDA raises."""
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r}; expected one of "
                         f"{SOLVERS}")
    if solver == "scan":
        return True
    if device_type != "cuda":
        if solver == "cuda":
            raise ValueError("solver='cuda' needs CUDA tensors; got device "
                             f"type {device_type!r}")
        return True
    return False


def resolve_family(static_kernel, device_type: str, solver: str) -> str:
    """Which solver family serves this tile?

    - ``solver="scan"``: the plain tier, on any device (an explicit choice).
    - CUDA tensors (``"auto"`` or ``"cuda"``): ``"gen"`` for exactly
      ``RBFKernel``, ``"lgen"`` for exactly ``LinearKernel``, ``"inc"`` for
      any other static kernel (subclasses included), or for a ready
      increment grid (``static_kernel=None``).
    - Other devices: ``"auto"`` takes the plain tier; ``"cuda"`` raises.
    """
    if _plain_tier(device_type, solver):
        return "scan"
    if type(static_kernel) is _kernels.RBFKernel:
        return "gen"
    if type(static_kernel) is _kernels.LinearKernel:
        return "lgen"
    return "inc"


def resolve_derivatives(device_type: str, solver: str,
                        needs_grad: bool) -> str:
    """The derivative Gram's route: ``"cuda"`` (K5) for CUDA tensors,
    ``"scan"`` on the CPU or when asked. K5 is forward only, as the JAX
    package's Pallas tier is: ``needs_grad`` (an input requires a gradient)
    on the ``"cuda"`` route raises rather than return a detached value."""
    if _plain_tier(device_type, solver):
        return "scan"
    if needs_grad:
        raise ValueError("the derivative Gram's CUDA route (K5) is forward "
                         "only and an input requires a gradient: call it "
                         "under torch.no_grad(), or pass solver='scan' for "
                         "the plain sweep, which autograd differentiates")
    return "cuda"


def resolve(static_kernel, device_type: str, solver: str,
            dtype: torch.dtype, grad_solver: str) -> Route:
    """The family (:func:`resolve_family`) and the dtype its backward runs
    in, for inputs of ``dtype``."""
    check_grad_solver(grad_solver)
    family = resolve_family(static_kernel, device_type, solver)
    if family != "scan" and grad_solver == "f32":
        return Route(family, torch.float32)
    return Route(family, dtype)
