"""K2: the increment-grid wavefront (``csrc/inc_wavefront.cu``).

Replaces the value path of ``sigkernel_tpu/ops/pallas_solver.py``
(``_wavefront_kernel``, ``_wavefront_f32_planes_kernel``) and of
``sigkernel_tpu/ops/pallas_df64.py`` (``_wavefront_df_kernel``,
``_wavefront_df_planes_kernel``): the corner ``K[MM, NN]`` of each pair's
Goursat solve over a base increment grid ``(P, Mb, Nb)`` refined by
``2^dyadic_order`` in the kernel. One block per pair; the ring of three
anti-diagonals of the shorter refined side lives in shared memory.

On the H100 it is bound by reading the increment grid from device memory;
the kernel reads it at base resolution and never builds the refined grid.

:func:`inc_solve_final` launches the kernel for CUDA tensors and takes
:func:`inc_solve_final_plain` only for CPU tensors. ``COUNTS`` holds the
kernel launches per dtype and the calls of the plain version.
"""
from __future__ import annotations

import torch

from . import _build, scan_solver
from ..utils import dyadic_refine

COUNTS = {"float32": 0, "float64": 0, "plain": 0}

_FNS = {torch.float32: "sk_inc_wavefront_f32",
        torch.float64: "sk_inc_wavefront_f64"}


def inc_solve_final_plain(inc: torch.Tensor, dyadic_order: int = 0,
                          naive: bool = False) -> torch.Tensor:
    """Plain version: refine the grid, then the plain anti-diagonal loop."""
    COUNTS["plain"] += 1
    return scan_solver.solve_final(dyadic_refine(inc, dyadic_order), naive)


def inc_solve_final(inc: torch.Tensor, dyadic_order: int = 0,
                    naive: bool = False) -> torch.Tensor:
    """``K[MM, NN]`` for each pair of a ``(P, Mb, Nb)`` base increment grid."""
    if inc.device.type == "cpu":
        return inc_solve_final_plain(inc, dyadic_order, naive)
    if inc.device.type != "cuda":
        raise ValueError(f"inc_solve_final: unsupported device {inc.device}")
    if inc.dtype not in _FNS:
        raise ValueError(f"inc_solve_final: dtype {inc.dtype}; expected "
                         "torch.float32 or torch.float64")
    if inc.dim() != 3:
        raise ValueError(f"inc_solve_final: expected (P, Mb, Nb); got "
                         f"shape {tuple(inc.shape)}")
    if not inc.is_contiguous():
        raise ValueError("inc_solve_final: the increment grid must be "
                         "contiguous")
    P, Mb, Nb = inc.shape
    if P == 0 or Mb == 0 or Nb == 0:
        # no pairs, or a length-1 path (K is its boundary, 1): no launch
        return inc.new_ones(P)
    f = 2 ** dyadic_order
    _build.check_rows(min(Mb, Nb) * f, inc.element_size(), "inc_solve_final")
    if P >= 2 ** 31:
        raise ValueError(f"inc_solve_final: {P} pairs exceed one launch")
    out = torch.empty(P, dtype=inc.dtype, device=inc.device)
    fn = getattr(_build.library(), _FNS[inc.dtype])
    device, stream = _build.stream_args(inc)
    _build.check(fn(inc.data_ptr(), out.data_ptr(), P, Mb, Nb, f, int(naive),
                    device, stream), "inc_wavefront")
    COUNTS[str(inc.dtype).removeprefix("torch.")] += 1
    return out
