"""K6: the Linear-generation wavefront (``csrc/linear_gen_wavefront.cu``).

K6 replaces ``sigkernel_tpu/ops/pallas_fused.py``'s ``_fused_kernel``: the
Linear signature kernel ``k_sig(X[ii[p]], Y[jj[p]])`` of each pair ``p``,
its increments ``<dx_a, dy_b> / f^2`` generated in the kernel from the
paths' scaled increments, so no increment grid exists. The pair index arrays
let one kernel serve pairwise kernels, Grams, the symmetric triangle and the
lincomb chunks, as K1 does for the RBF kernel. Forward only; the ``lgen``
family's backward runs the increment-grid adjoint (K2-stack, K3<inc>).

The wrapper launches the kernel for CUDA tensors and takes its plain
version (:func:`linear_gen_solve_final_plain`) only for CPU tensors.
``COUNTS`` holds the kernel launches per dtype and the calls of the plain
version.
"""
from __future__ import annotations

import torch

from . import _build, cuda_gen, scan_solver
from ..tracing import spanned
from ..utils import dyadic_refine

COUNTS = {"float32": 0, "float64": 0, "plain": 0}

_FNS = {torch.float32: "sk_linear_gen_wavefront_f32",
        torch.float64: "sk_linear_gen_wavefront_f64"}


def scaled_increments(X, scale) -> torch.Tensor:
    """``(A, M, D)`` paths -> ``(A, M-1, D)`` increments of ``X * scale``,
    the scale applied to the points before the difference (the TPU kernel's
    ``_refined_increments``); ``scale`` a number or a 0-d tensor."""
    if isinstance(scale, torch.Tensor):
        s = scale.detach().to(X)
    else:
        s = torch.as_tensor(scale, dtype=X.dtype, device=X.device)
    Xs = X * s
    return (Xs[:, 1:] - Xs[:, :-1]).contiguous()


def pair_increments(dx, dy) -> torch.Tensor:
    """Base increment grids ``(P, M-1, N-1)`` of the pairs ``(dx[p],
    dy[p])``: ``<dx_a, dy_b>`` summed over the coordinates in order, the
    kernel's op order."""
    dot = dx[:, :, None, 0] * dy[:, None, :, 0]
    for d in range(1, dx.shape[-1]):
        dot = dot + dx[:, :, None, d] * dy[:, None, :, d]
    return dot


def linear_gen_solve_final_plain(X, Y, ii, jj, scale, dyadic_order: int = 0,
                                 naive: bool = False) -> torch.Tensor:
    """Plain version: per pair the increments (:func:`pair_increments`) ->
    dyadic refinement -> the plain anti-diagonal loop."""
    COUNTS["plain"] += 1
    dX, dY = scaled_increments(X, scale), scaled_increments(Y, scale)
    chunk = cuda_gen.plain_chunk(X, Y, dyadic_order, 2)
    outs = [X.new_empty(0)]
    for s in range(0, ii.shape[0], chunk):
        inc = pair_increments(dX[ii[s:s + chunk]], dY[jj[s:s + chunk]])
        outs.append(scan_solver.solve_final(dyadic_refine(inc, dyadic_order),
                                            naive))
    return torch.cat(outs)


@spanned("sk.op.linear_gen_wavefront")
def linear_gen_solve_final(X, Y, ii, jj, scale, dyadic_order: int = 0,
                           naive: bool = False, *,
                           in_range: bool = False) -> torch.Tensor:
    """Linear signature kernel of the pairs ``(X[ii[p]], Y[jj[p]])`` ->
    ``(P,)``. ``X``: ``(A, M, D)``, ``Y``: ``(B, N, D)``; ``scale`` a number
    or a 0-d tensor (the kernel takes the scaled increments); ``in_range``
    as :func:`.cuda_gen.rbf_gen_solve_final`'s."""
    if X.device.type == "cpu":
        return linear_gen_solve_final_plain(X, Y, ii, jj, scale,
                                            dyadic_order, naive)
    ii, jj = cuda_gen.check_pairs(X, Y, ii, jj, "linear_gen_solve_final",
                                  in_range=in_range)
    P, M, N, D = ii.shape[0], X.shape[1], Y.shape[1], X.shape[2]
    if P == 0 or M < 2 or N < 2 or D == 0:
        # no pairs, or no increments (K is its boundary, 1): no launch
        return X.new_ones(P)
    f = 2 ** dyadic_order
    dX, dY = scaled_increments(X, scale), scaled_increments(Y, scale)
    if M <= N:
        rows, ri, cols, ci = dX, ii, dY, jj
    else:
        rows, ri, cols, ci = dY, jj, dX, ii
    _build.check_rows(rows.shape[1] * f, X.element_size(),
                      "linear_gen_solve_final")
    out = torch.empty(P, dtype=X.dtype, device=X.device)
    _build.launch("linear_gen_wavefront", _FNS, COUNTS, X, rows.data_ptr(),
                  cols.data_ptr(), ri.data_ptr(), ci.data_ptr(),
                  out.data_ptr(), P, rows.shape[1], cols.shape[1], D, f,
                  int(naive))
    return out
