"""The yardstick: the least time the card could take for a call's
mathematics, counted from the call's shapes.

Bytes: each path read once, each output written once (the values and the
requested gradients). No stack, grid, scratch or cotangent is counted, so a
design that keeps none reads against the same count. Operations: the
scheme's once a refined cell and the static kernel's increments once a base
cell, however often a kernel recomputes them:

- a value: the forward sweep, 10 a refined cell; the base increments, 5 a
  base cell; the static kernel's values, its ``point_ops`` a point pair
  (``static_kernels/<name>.py``; the RBF kernel's ``6 D + 6``);
- its gradient as well: the reverse sweep with the product and the
  collapse, 12 a refined cell; the increment chain's VJP, in the static
  kernel's ``point_ops`` with ``grad`` (the RBF kernel's ``10 D + 13``
  more).

The same count holds whatever route or kernel implements the call.

Peaks: one NVIDIA H100 SXM (data sheet, dense, outside the tensor cores, at
its 700 W power limit): 3.35 TB/s of HBM, 67 TFLOP/s in float32 and 34 in
float64. A card set below 700 W is slower; the result line names the
card's limit beside the share.
"""
from __future__ import annotations

HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
ITEMSIZE = {"float32": 4, "float64": 8}


def pair_ops(M, N, f, grad, point_ops):
    """Operations of one pair of paths of lengths ``M`` and ``N`` at
    refinement ``f``, ``point_ops`` those of the static kernel a point
    pair: its value, and with ``grad`` its gradient."""
    Mb, Nb = max(M - 1, 0), max(N - 1, 0)
    cells, base = Mb * f * Nb * f, Mb * Nb
    return (10 + (12 if grad else 0)) * cells + 5 * base + point_ops * M * N


def call_work(pairs, M, N, D, f, grad, paths_in, floats_out, point_ops):
    """``(values moved, operations)`` of a call: ``pairs`` pairs,
    ``paths_in`` paths read (each ``M`` or ``N`` points of ``D`` values,
    the longer counted), ``floats_out`` values written."""
    return ((paths_in * max(M, N) * D + floats_out),
            pairs * pair_ops(M, N, f, grad, point_ops))


def least_seconds(values, ops, dtype):
    """The larger of the bytes of ``values`` values of ``dtype`` over the
    memory rate and the operations over the peak in ``dtype``."""
    return max(values * ITEMSIZE[dtype] / HBM_BYTES_S,
               ops / PEAK_FLOPS[dtype])
