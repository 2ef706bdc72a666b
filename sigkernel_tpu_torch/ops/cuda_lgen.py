"""K6: the Linear-generation wavefront (``csrc/linear_gen_wavefront.cu``);
K10 and K11: the Linear increment grids and their VJP
(``csrc/linear_gen_increments.cu``, ``csrc/linear_dd_vjp.cu``).

K6 replaces ``sigkernel_tpu/ops/pallas_fused.py``'s ``_fused_kernel``: the
Linear signature kernel ``k_sig(X[ii[p]], Y[jj[p]])`` of each pair ``p``,
its increments ``<dx_a, dy_b> / f^2`` generated in the kernel from the
paths' scaled increments, so no increment grid exists. The pair index arrays
let one kernel serve pairwise kernels, Grams, the symmetric triangle and the
lincomb chunks, as K1 does for the RBF kernel. Forward only.

K10 (:func:`linear_gen_increments`) and K11 (:func:`linear_dd_vjp`) replace
no TPU kernel: the JAX package builds the Linear grid in XLA and
differentiates it by ``jax.vjp``. They serve the gradient of exactly
``LinearKernel`` on the ``inc`` and ``lgen`` families
(``sigkernel._GridPairs``, whose backward ``_LinearGen`` inherits): K10
writes each chunk's base grids ``<a_i, b_j>`` from the scaled increments
(:func:`scaled_increments`) with K6's arithmetic, and K11 maps the grids'
cotangent to the increments of each pair in one read of it; the scatter
onto the paths and ``scale``'s gradient (:func:`scaled_increments_vjp`)
are small PyTorch passes.

The wrappers launch the kernels for CUDA tensors and take their plain
versions (the ``*_plain`` functions) only for CPU tensors. ``COUNTS``,
``INCREMENT_COUNTS`` and ``VJP_COUNTS`` hold K6's, K10's and K11's
launching calls per dtype and the calls of their plain versions.
"""
from __future__ import annotations

import torch

from . import _build, cuda_gen, scan_solver
from ..tracing import spanned
from ..utils import dyadic_refine

COUNTS = {"float32": 0, "float64": 0, "plain": 0}
INCREMENT_COUNTS = {"float32": 0, "float64": 0, "plain": 0}
VJP_COUNTS = {"float32": 0, "float64": 0, "plain": 0}

_FNS = {torch.float32: "sk_linear_gen_wavefront_f32",
        torch.float64: "sk_linear_gen_wavefront_f64"}
_INCREMENT_FNS = {torch.float32: "sk_linear_gen_increments_f32",
                  torch.float64: "sk_linear_gen_increments_f64"}
_VJP_FNS = {torch.float32: "sk_linear_dd_vjp_f32",
            torch.float64: "sk_linear_dd_vjp_f64"}
# K11's tiling (csrc/linear_dd_vjp.cu): rows a band, columns a chunk, and
# the coordinates a pass, which size its scratch
VJP_ROWS, VJP_CHUNK, VJP_PASS_DIM = 64, 512, 8


def _scale(scale, X) -> torch.Tensor:
    """``scale`` (a number or a 0-d tensor) as a 0-d tensor of ``X``'s dtype
    and device, detached: no host read."""
    if isinstance(scale, torch.Tensor):
        return scale.detach().to(X)
    return torch.as_tensor(scale, dtype=X.dtype, device=X.device)


def scaled_increments(X, scale) -> torch.Tensor:
    """``(A, M, D)`` paths -> ``(A, M-1, D)`` increments of ``X * scale``,
    the scale applied to the points before the difference (the TPU kernel's
    ``_refined_increments``); ``scale`` a number or a 0-d tensor."""
    Xs = X * _scale(scale, X)
    return (Xs[:, 1:] - Xs[:, :-1]).contiguous()


def scaled_increments_vjp(X, scale, du):
    """``(dX, d scale)`` of ``sum(du * scaled_increments(X, scale))``:
    ``dX[m] = scale (du[m-1] - du[m])`` (the difference's transpose) and
    ``d scale = sum(du * (X[1:] - X[:-1]))``, with no division by
    ``scale``."""
    g = du * _scale(scale, X)
    pad = torch.nn.functional.pad
    dX = pad(g, (0, 0, 1, 0)) - pad(g, (0, 0, 0, 1))
    return dX, torch.sum(du * (X[:, 1:] - X[:, :-1]))


def pair_increments(dx, dy) -> torch.Tensor:
    """Base increment grids ``(P, M-1, N-1)`` of the pairs ``(dx[p],
    dy[p])``: ``<dx_a, dy_b>`` summed over the coordinates in order, the
    kernel's op order."""
    dot = dx[:, :, None, 0] * dy[:, None, :, 0]
    for d in range(1, dx.shape[-1]):
        dot = dot + dx[:, :, None, d] * dy[:, None, :, d]
    return dot


def linear_gen_increments_plain(dX, dY, ii, jj) -> torch.Tensor:
    """Plain version of K10: :func:`pair_increments` of the gathered pairs
    ``(dX[ii[p]], dY[jj[p]])`` -> ``(P, M-1, N-1)``."""
    INCREMENT_COUNTS["plain"] += 1
    if dX.shape[2] == 0:
        return dX.new_zeros(ii.shape[0], dX.shape[1], dY.shape[1])
    return pair_increments(dX[ii], dY[jj])


def linear_dd_vjp_plain(dX, dY, ii, jj, ct):
    """Plain version of K11: ``(U (P, M-1, D), V (P, N-1, D))``, the
    cotangents of the increments ``dX[ii[p]]`` and ``dY[jj[p]]`` of
    ``sum(ct * pair_increments(...))``: ``ct @ dY[jj]`` and ``ct^T @
    dX[ii]``."""
    VJP_COUNTS["plain"] += 1
    return torch.bmm(ct, dY[jj]), torch.bmm(ct.transpose(1, 2), dX[ii])


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


@spanned("sk.op.linear_gen_increments")
def linear_gen_increments(dX, dY, ii, jj, *,
                          in_range: bool = False) -> torch.Tensor:
    """K10: the base Linear increment grids ``(P, M-1, N-1)`` of the pairs
    ``(dX[ii[p]], dY[jj[p]])`` of scaled increments
    (:func:`scaled_increments` of the paths, ``(A, M-1, D)`` and ``(B, N-1,
    D)``), each pair in its own frame: :func:`pair_increments`' op order, bit
    for bit. ``in_range`` as :func:`linear_gen_solve_final`'s."""
    if dX.device.type == "cpu":
        return linear_gen_increments_plain(dX, dY, ii, jj)
    ii, jj = cuda_gen.check_pairs(dX, dY, ii, jj, "linear_gen_increments",
                                  in_range=in_range)
    P, Mb, Nb, D = ii.shape[0], dX.shape[1], dY.shape[1], dX.shape[2]
    if D == 0:
        return dX.new_zeros(P, Mb, Nb)
    out = torch.empty((P, Mb, Nb), dtype=dX.dtype, device=dX.device)
    if P == 0 or Mb == 0 or Nb == 0:
        return out
    _build.launch("linear_gen_increments", _INCREMENT_FNS, INCREMENT_COUNTS,
                  dX, dX.data_ptr(), dY.data_ptr(), ii.data_ptr(),
                  jj.data_ptr(), out.data_ptr(), P, Mb, Nb, D)
    return out


@spanned("sk.op.linear_dd_vjp")
def linear_dd_vjp(dX, dY, ii, jj, ct, *, in_range: bool = False):
    """K11: ``(U (P, M-1, D), V (P, N-1, D))``, the cotangents of the
    increments ``dX[ii[p]]`` and ``dY[jj[p]]`` given ``ct (P, M-1, N-1)``,
    the cotangent of their grids (:func:`linear_gen_increments`), in the
    increments' dtype, with fixed-order sums (two launches agree bit for
    bit). ``in_range`` as :func:`linear_gen_solve_final`'s."""
    if dX.device.type == "cpu":
        return linear_dd_vjp_plain(dX, dY, ii, jj, ct)
    ii, jj = cuda_gen.check_pairs(dX, dY, ii, jj, "linear_dd_vjp",
                                  in_range=in_range)
    P, Mb, Nb, D = ii.shape[0], dX.shape[1], dY.shape[1], dX.shape[2]
    if (ct.shape != (P, Mb, Nb) or ct.dtype != dX.dtype
            or ct.device != dX.device or not ct.is_contiguous()):
        raise ValueError(f"linear_dd_vjp: ct must be a contiguous "
                         f"{(P, Mb, Nb)} tensor of the increments' dtype "
                         "and device")
    if P == 0 or Mb == 0 or Nb == 0 or D == 0:
        return dX.new_zeros(P, Mb, D), dY.new_zeros(P, Nb, D)
    W = min(D, VJP_PASS_DIM)
    new = lambda *shape: torch.empty(shape, dtype=dX.dtype,  # noqa: E731
                                     device=dX.device)
    U, V = new(P, Mb, D), new(P, Nb, D)
    upart = new(P, -(-Nb // VJP_CHUNK), Mb, W)
    vpart = new(P, -(-Mb // VJP_ROWS), Nb, W)
    _build.launch("linear_dd_vjp", _VJP_FNS, VJP_COUNTS, dX, dX.data_ptr(),
                  dY.data_ptr(), ii.data_ptr(), jj.data_ptr(), ct.data_ptr(),
                  U.data_ptr(), V.data_ptr(), upart.data_ptr(),
                  vpart.data_ptr(), P, Mb, Nb, D)
    return U, V
