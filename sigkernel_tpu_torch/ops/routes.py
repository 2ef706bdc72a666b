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
          (with a gradient, for exactly          K2-stack, K3<inc> or
          ``RBFKernel``: K9 ``cuda_gen``)        K2-sparse, K8 (then K4
                                                 for ``RBFKernel``)
``scan``  the same increments, plain loop        none (``scan_solver``)
========  =====================================  ==========================

The generators (``gen``, ``lgen``) hold only while the shorter refined side
fits one block (:func:`._build.max_rows`) and, when a gradient is wanted,
while one backward chunk holds enough full stacks (the ckpt gates,
:data:`GEN_CKPT_MIN_PAIRS` and :data:`CKPT_MIN_PAIRS`, by
:func:`resolve_inc_tier`); otherwise the tile takes ``inc``, as JAX's RBF
route leaves the generator past its gates (``sigkernel.py:290-316``). With
a gradient, the ``inc`` family builds each chunk's increment grid and drops
it, and the backward builds it again (``sigkernel._GridPairs``), so memory
is one chunk's grids and stacks at any tile size; for exactly
``RBFKernel`` the grid comes from K9 and its cotangent goes to the paths
and ``sigma`` by K4, any other static kernel's by autograd through the
grid built in torch. The ``inc`` family picks
its tier by shape (:func:`resolve_inc_tier`):

=============  =========================  ===================================
tier           when                       kernels
=============  =========================  ===================================
``single``     R within the row bound     K2 (forward)
``stripes``    R past it                  K7 per stripe (forward)
``full``       R within, ckpt gate holds  K2-stack, K3<inc> (backward)
``ckpt``       R within, gate fails       K2-sparse, K8 (backward)
``striped``    R past the row bound       K7, K7-stack, K3<inc, boundary>
=============  =========================  ===================================

K2, K2-stack and K2-sparse run on the band kernel and have no row bound
themselves; the tiers keep the bound for K3<inc>, whose ring of three
diagonals sits in one block's shared memory.

Every decision is made from shapes before any launch; nothing catches a
kernel's failure to try another route. The memory policy is here too:
:data:`STACK_BYTES` bounds what one chunk of pairs keeps alive
(:func:`tier_bytes` a pair, :func:`chunk_pairs` pairs a chunk), and
:data:`CKPT_MIN_PAIRS` and :data:`GEN_CKPT_MIN_PAIRS` are the ckpt gates.

The derivative Gram (:func:`resolve_derivatives`) has its own two routes:
``cuda``, K5 ``cuda_deriv`` (forward only, at any length), and ``scan``, the
plain triple sweep, which autograd differentiates.

The backward's dtype (``grad_solver``): ``"auto"`` and ``"df64"`` give
gradients at the input precision (on Hopper, ``df64`` is native double);
``"f32"`` runs the kernel chain in float32 and casts the gradients back to
the input dtype. The ``scan`` family ignores the grade: its gradients are at
the input precision, as the JAX scan tier's are.
"""
from __future__ import annotations

import math
import warnings
from typing import NamedTuple

import torch

from . import _build, band, cuda_blocked, cuda_solver
from .. import kernels as _kernels

SOLVERS = ("auto", "scan", "cuda")
FAMILIES = ("gen", "lgen", "inc", "scan")
INC_TIERS = ("single", "stripes")
INC_BWD_TIERS = ("full", "ckpt", "striped")
DERIV_ROUTES = ("cuda", "scan")
GRAD_SOLVERS = ("auto", "f32", "df64")

# what one chunk of pairs keeps alive: its forward stacks, and separately
# the increment grids it builds
STACK_BYTES = 8 << 30
# the ckpt gates: a full backward while a chunk holds at least this many
# pairs' full stacks; the sparse stack (K2-sparse, K8) otherwise. Each full
# backward has its own gate, as chip_smoke.py phase 12 times each against
# the sparse route (f64, dyadic 2; PERF.md section 5, on an H100 80GB HBM3
# at 700 W).
# CKPT_MIN_PAIRS: K2-stack -> K3<inc> (the inc family and lgen). K3<inc> is
# one block a pair, so the gate asks for a chunk that fills the card's 132
# SMs. The sweep found the sparse route the faster even so, at every point
# to 128 full stacks a chunk (1.2-1.5x at 128, about 3x at 32): the gate is
# too low, and is kept until K3<inc> is redesigned and swept past 128.
CKPT_MIN_PAIRS = 128
# GEN_CKPT_MIN_PAIRS: K1-stack -> K3<gen> -> K4 (the gen family), whose band
# kernels fill the card at any pair count. With K2 and K2-sparse on the
# band kernel too, the gate sweep found the sparse route the faster at 5,
# 8, 13 and 17 full stacks a chunk (by 1.12-1.69x) and the full route at
# 64 and 128 (by 1.07-2.72x, at a lower peak): the gate is the smallest
# point from which the full route won at every point measured. Between 17
# and 64 it is unmeasured but at 32 (phase 12's scoring rule, a tie).
GEN_CKPT_MIN_PAIRS = 64
# base grids a pair that building one increment grid keeps alive: the
# kernel's exponent and its exp (saved for autograd), the double difference
GRID_COPIES = 3


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


def _bwd_dtype(dtype: torch.dtype, grad_solver: str) -> torch.dtype:
    return torch.float32 if grad_solver == "f32" else dtype


def tier_bytes(tier: str, shape, itemsize: int) -> int:
    """Bytes one pair keeps alive on an ``inc`` tier for a refined ``(MM,
    NN)`` grid: the full stack (``full``), the sparse stack and K8's
    scratch (``ckpt``: the band kernel's hand-off rows and counters, or the
    one-block kernel's window of diagonals past f = 32, whichever is larger,
    as the refined shape does not say which kernel runs), one stripe's
    stack (``striped``; the stripe height at most
    :data:`.cuda_blocked.ADJ_ROWS`); nothing on the forward tiers."""
    R, C = min(shape), max(shape)
    if tier == "full":
        n = math.prod(cuda_solver.stack_shape(1, R, C))
    elif tier == "ckpt":
        one_block = cuda_solver.CKPT_WINDOW * (R + 1) * itemsize
        return (math.prod(cuda_solver.sparse_shape(1, R, C)) * itemsize
                + max(band.scratch_bytes(R, C, itemsize), one_block))
    elif tier == "striped":
        n = math.prod(cuda_solver.stack_shape(
            1, min(cuda_blocked.ADJ_ROWS, R), C))
    else:
        n = 0
    return n * itemsize


def grid_bytes(Mb: int, Nb: int, itemsize: int) -> int:
    """Bytes one pair keeps alive while its base increment grid ``(Mb, Nb)``
    is built (:data:`GRID_COPIES` grids)."""
    return GRID_COPIES * Mb * Nb * itemsize


def chunk_pairs(P: int, per_pair: int) -> int:
    """Pairs of one chunk that keep ``per_pair`` bytes each within
    :data:`STACK_BYTES` (at least one; all ``P`` when a pair keeps
    nothing)."""
    if per_pair <= 0:
        return max(P, 1)
    return max(1, min(P, STACK_BYTES // per_pair))


def resolve_inc_tier(shape, itemsize: int, backward: bool = False,
                     min_pairs: int | None = None) -> str:
    """The ``inc`` family's tier for a refined ``(MM, NN)`` grid of
    ``itemsize``-byte values: forward ``"single"`` (K2) or ``"stripes"``
    (K7); backward ``"full"`` (K2-stack, K3<inc>), ``"ckpt"`` (K2-sparse,
    K8) or ``"striped"``.

    The ckpt gate is capacity only, as JAX's is (``ops/solve.py:386-395``):
    the full stack is taken while :data:`STACK_BYTES` holds at least
    ``min_pairs`` pairs' full stacks (:data:`CKPT_MIN_PAIRS` when not
    given), or for a length-1 path, which stores nothing.
    """
    if min(shape) > _build.max_rows(itemsize):
        return "striped" if backward else "stripes"
    if not backward:
        return "single"
    if min_pairs is None:
        min_pairs = CKPT_MIN_PAIRS
    if (min(shape) == 0 or STACK_BYTES // tier_bytes("full", shape, itemsize)
            >= min_pairs):
        return "full"
    return "ckpt"


def _warn_f32_long(shape, dtype, grad_solver, need_grad) -> None:
    """float32 sweeps past the float32 row bound drift far from float64:
    say so (PERF.md: measured on an H100 at a 20,000^2 grid)."""
    f32 = dtype == torch.float32 or (need_grad and grad_solver == "f32")
    if f32 and min(shape) > _build.max_rows(4):
        warnings.warn(
            f"float32 sweeps of a {shape[0]} x {shape[1]} refined grid: past "
            f"{_build.max_rows(4)} rows the float32 values and the "
            "grad_solver='f32' gradients drift far from float64 (measured "
            "on an H100 at a 20,000 x 20,000 grid: 1.1e-1 of max |K|, 0.86 "
            "of max |dX|); "
            "float64 paths with the default grade hold", RuntimeWarning,
            stacklevel=3)


def resolve_family(static_kernel, device_type: str, solver: str,
                   shape=None, dtype: torch.dtype = torch.float64,
                   grad_solver: str = "auto", need_grad: bool = False) -> str:
    """Which solver family serves this tile?

    - ``solver="scan"``: the plain tier, on any device (an explicit choice).
    - CUDA tensors (``"auto"`` or ``"cuda"``): ``"gen"`` for exactly
      ``RBFKernel``, ``"lgen"`` for exactly ``LinearKernel``, ``"inc"`` for
      any other static kernel (subclasses included), or for a ready
      increment grid (``static_kernel=None``). Given the tile's refined
      ``shape`` ``(MM, NN)``, a generator holds only while the shorter side
      is within the row bound in ``dtype`` and, with ``need_grad``, while
      the backward (in the grade's dtype) takes the ``"full"`` tier at the
      family's gate (:data:`GEN_CKPT_MIN_PAIRS` for ``"gen"``,
      :data:`CKPT_MIN_PAIRS` for ``"lgen"``, whose backward is K3<inc>);
      otherwise the tile takes ``"inc"``.
    - Other devices: ``"auto"`` takes the plain tier; ``"cuda"`` raises.

    A CUDA tile whose float32 sweeps (``dtype``, or the ``"f32"`` grade
    with ``need_grad``) pass the float32 row bound warns: their error there
    is large (PERF.md).
    """
    if _plain_tier(device_type, solver):
        return "scan"
    if shape is not None:
        _warn_f32_long(shape, dtype, grad_solver, need_grad)
    if type(static_kernel) is _kernels.RBFKernel:
        family = "gen"
    elif type(static_kernel) is _kernels.LinearKernel:
        family = "lgen"
    else:
        return "inc"
    if shape is None:
        return family
    gate = GEN_CKPT_MIN_PAIRS if family == "gen" else CKPT_MIN_PAIRS
    if resolve_inc_tier(shape, dtype.itemsize) != "single" or (
            need_grad and resolve_inc_tier(
                shape, _bwd_dtype(dtype, grad_solver).itemsize,
                backward=True, min_pairs=gate) != "full"):
        return "inc"
    return family


def resolve_derivatives(device_type: str, solver: str, needs_grad: bool,
                        shape, itemsize: int) -> str:
    """The derivative Gram's route for a refined ``(MM, NN)`` grid of
    ``itemsize``-byte values: ``"cuda"`` (K5) for CUDA tensors, at any
    shape and itemsize (K5 holds nothing of the grid in shared memory, so
    no row bound applies, unlike JAX's Pallas tier, ``sigkernel.py:935-939``);
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
            dtype: torch.dtype, grad_solver: str, shape=None,
            need_grad: bool = False) -> Route:
    """The family (:func:`resolve_family`) and the dtype its backward runs
    in, for inputs of ``dtype``."""
    check_grad_solver(grad_solver)
    family = resolve_family(static_kernel, device_type, solver, shape=shape,
                            dtype=dtype, grad_solver=grad_solver,
                            need_grad=need_grad)
    if family != "scan":
        return Route(family, _bwd_dtype(dtype, grad_solver))
    return Route(family, dtype)
