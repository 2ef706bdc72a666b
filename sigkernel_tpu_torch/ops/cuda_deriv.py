"""K5: the triple wavefront of the derivative Gram
(``csrc/deriv_wavefront.cu``).

K5 replaces ``sigkernel_tpu/ops/pallas_derivatives.py``'s ``_deriv_kernel``
(float) and ``_deriv_kernel_df`` (double): the corners of ``(K, K_diff,
K_diffdiff)`` of each pair, swept together over three base increment grids
``(P, Mb, Nb)`` (of the static-kernel Gram and of its first and second
directional derivatives) refined by ``2^dyadic_order`` in the kernel. One
block per pair. Forward only, as the TPU kernels are.

The wrapper launches the kernel for CUDA tensors and takes its plain
version (:func:`deriv_solve_final_plain`) only for CPU tensors. ``COUNTS``
holds the kernel launches per dtype and the calls of the plain version.
"""
from __future__ import annotations

import torch

from . import _build, scan_solver
from ..utils import dyadic_refine

COUNTS = {"float32": 0, "float64": 0, "plain": 0}

_FNS = {torch.float32: "sk_deriv_wavefront_f32",
        torch.float64: "sk_deriv_wavefront_f64"}


def max_rows(itemsize: int) -> int:
    """The longest shorter refined side K5 serves: three states of two
    slots of ``R + 2`` values each in one block's shared memory (4,840 rows
    in double, 9,683 in float; see the note in the kernel's source)."""
    return _build.SMEM_BYTES // (6 * itemsize) - 2


def check_rows(rows: int, itemsize: int, what: str) -> None:
    """Raise past K5's shared-memory bound (:func:`max_rows`)."""
    bound = max_rows(itemsize)
    if rows > bound:
        raise ValueError(
            f"{what}: the shorter refined side has {rows} rows; K5 keeps "
            f"6 x (rows + 2) values of {itemsize} bytes in shared memory, at "
            f"most {_build.SMEM_BYTES} bytes ({bound} rows)")


def deriv_solve_final_plain(inc, inc_d, inc_dd, dyadic_order: int = 0):
    """Plain version: in the kernel's frame (the grids transposed when
    ``Mb > Nb``; the f2/f3 terms swap under a transpose and round
    otherwise), refine the three grids, then
    :func:`.scan_solver.solve_derivatives_final`."""
    COUNTS["plain"] += 1
    grids = (inc, inc_d, inc_dd)
    if inc.shape[-2] > inc.shape[-1]:
        grids = tuple(g.transpose(-1, -2) for g in grids)
    return scan_solver.solve_derivatives_final(
        *(dyadic_refine(g, dyadic_order) for g in grids))


def deriv_solve_final(inc, inc_d, inc_dd, dyadic_order: int = 0):
    """``(K, K_diff, K_diffdiff)`` corners, each ``(P,)``, of three
    ``(P, Mb, Nb)`` base increment grids."""
    if inc.device.type == "cpu":
        return deriv_solve_final_plain(inc, inc_d, inc_dd, dyadic_order)
    for name, t in (("inc", inc), ("inc_d", inc_d), ("inc_dd", inc_dd)):
        if t.device.type != "cuda" or t.device != inc.device:
            raise ValueError(f"deriv_solve_final: {name} is on {t.device}")
        if t.dtype not in _FNS or t.dtype != inc.dtype:
            raise ValueError(f"deriv_solve_final: {name} has dtype {t.dtype}; "
                             "expected one of torch.float32, torch.float64 "
                             "for all three grids")
        if t.dim() != 3 or t.shape != inc.shape or not t.is_contiguous():
            raise ValueError("deriv_solve_final: the grids must be "
                             "contiguous (P, Mb, Nb) tensors of one shape")
        if t.requires_grad and torch.is_grad_enabled():
            raise ValueError("deriv_solve_final: the CUDA kernel is forward "
                             f"only, and {name} requires a gradient")
    P, Mb, Nb = inc.shape
    if P >= 2 ** 31:
        raise ValueError(f"deriv_solve_final: {P} pairs exceed one launch")
    if P == 0 or Mb == 0 or Nb == 0:
        # no pairs, or a length-1 path (the boundary values): no launch
        return inc.new_ones(P), inc.new_zeros(P), inc.new_zeros(P)
    f = 2 ** dyadic_order
    check_rows(min(Mb, Nb) * f, inc.element_size(), "deriv_solve_final")
    outs = [torch.empty(P, dtype=inc.dtype, device=inc.device)
            for _ in range(3)]
    _build.launch("deriv_wavefront", _FNS, COUNTS, inc, inc.data_ptr(),
                  inc_d.data_ptr(), inc_dd.data_ptr(),
                  *(o.data_ptr() for o in outs), P, Mb, Nb, f)
    return tuple(outs)
