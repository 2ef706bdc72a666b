"""The one route resolver of the port's forward path.

Every decision about which solver a tile takes goes through
:func:`resolve_family`, so the whole matrix is enumerable in one place
(``tests/test_torch_routes.py``). It takes the device *type string*, so the
CPU tests pin the CUDA rows too. Callers reach it through this module object
(``routes.resolve_family``), so a test can steer the route by patching it.

========  =====================================  ==========================
family    computation                            kernel
========  =====================================  ==========================
``gen``   RBF increments generated in-kernel     K1 ``cuda_gen``
``inc``   ``double_difference(Gram)`` in torch   K2 ``cuda_solver``
``scan``  the same increments, plain loop        none (``scan_solver``)
========  =====================================  ==========================
"""
from __future__ import annotations

from .. import kernels as _kernels

SOLVERS = ("auto", "scan", "cuda")
FAMILIES = ("gen", "inc", "scan")


def resolve_family(static_kernel, device_type: str, solver: str) -> str:
    """Which solver family serves this tile?

    - ``solver="scan"``: the plain tier, on any device (an explicit choice).
    - CUDA tensors (``"auto"`` or ``"cuda"``): ``"gen"`` for exactly
      ``RBFKernel``, ``"inc"`` for any other static kernel, or for a ready
      increment grid (``static_kernel=None``).
    - Other devices: ``"auto"`` takes the plain tier; ``"cuda"`` raises.
    """
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r}; expected one of "
                         f"{SOLVERS}")
    if solver == "scan":
        return "scan"
    if device_type != "cuda":
        if solver == "cuda":
            raise ValueError("solver='cuda' needs CUDA tensors; got device "
                             f"type {device_type!r}")
        return "scan"
    if type(static_kernel) is _kernels.RBFKernel:
        return "gen"
    return "inc"
