"""K1: the RBF-generation wavefront (``csrc/rbf_gen_wavefront.cu``).

Replaces the value path of ``sigkernel_tpu/ops/pallas_gen32.py``
(``_wavefront_f32_gen_kernel``), ``sigkernel_tpu/ops/pallas_df64.py``
(``_wavefront_df_gen_kernel``) and ``sigkernel_tpu/ops/pallas_fused.py``
(``_fused_rbf_kernel``, ``_fused_rbf_dyadic_kernel``): the RBF signature
kernel ``k_sig(X[ii[p]], Y[jj[p]])`` of each pair ``p``, with the increments
``dd(exp(-|x - y|^2 / sigma))`` generated in the kernel from the path points.
Nothing but paths goes in and values come out; the pair index arrays let one
kernel serve pairwise kernels, Grams, the symmetric triangle and the
linear-combination chunks without copying paths per pair.

On the H100 it is bound by arithmetic and ``exp``: four ``exp`` per refined
cell in this simple form.

:func:`rbf_gen_solve_final` launches the kernel for CUDA tensors and takes
:func:`rbf_gen_solve_final_plain` only for CPU tensors. ``COUNTS`` holds the
kernel launches per dtype and the calls of the plain version.
"""
from __future__ import annotations

import torch

from . import _build, scan_solver
from ..utils import dyadic_refine

COUNTS = {"float32": 0, "float64": 0, "plain": 0}

_FNS = {torch.float32: "sk_rbf_gen_wavefront_f32",
        torch.float64: "sk_rbf_gen_wavefront_f64"}

# the plain version solves pairs in chunks whose refined grids stay near this
_PLAIN_CHUNK_BYTES = 1 << 30


def gen_increments(x, y, sigma) -> torch.Tensor:
    """The base increment grids ``(P, M-1, N-1)`` of the pairs ``(x[p], y[p])``
    in the kernel's op order: ``G = exp(-((|x|^2 + |y|^2) - 2 <x, y>) /
    sigma)`` with each sum taken over the coordinates in order, then
    ``(g11 + g00) - (g10 + g01)``.

    The same quantity as ``double_difference(RBFKernel(sigma).batch_kernel(x,
    y))``; the op order is the kernel's so that the float32 check on the card
    compares like with like (other orders move float32 values by up to 1e-3
    at length 1024, dyadic 2).
    """
    xy = x[:, :, None, :] * y[:, None, :, :]
    xx, yy = x * x, y * y
    dot, sx, sy = xy[..., 0], xx[..., 0], yy[..., 0]
    for d in range(1, x.shape[-1]):
        dot, sx, sy = dot + xy[..., d], sx + xx[..., d], sy + yy[..., d]
    sigma = torch.as_tensor(sigma, dtype=x.dtype, device=x.device)
    G = torch.exp(-((sx[:, :, None] + sy[:, None, :]) - 2.0 * dot) / sigma)
    return (G[:, 1:, 1:] + G[:, :-1, :-1]) - (G[:, 1:, :-1] + G[:, :-1, 1:])


def rbf_gen_solve_final_plain(X, Y, ii, jj, sigma, dyadic_order: int = 0,
                              naive: bool = False) -> torch.Tensor:
    """Plain version: per pair the RBF increments (:func:`gen_increments`)
    -> dyadic refinement -> the plain anti-diagonal loop."""
    COUNTS["plain"] += 1
    f = 2 ** dyadic_order
    M, N, D = X.shape[1], Y.shape[1], X.shape[2]
    per_pair = (M * N * (D + 4) + 2 * f * f * max(M - 1, 0) * max(N - 1, 0)) \
        * X.element_size()
    chunk = max(1, _PLAIN_CHUNK_BYTES // max(per_pair, 1))
    outs = [X.new_empty(0)]
    for s in range(0, ii.shape[0], chunk):
        inc = gen_increments(X[ii[s:s + chunk]], Y[jj[s:s + chunk]], sigma)
        outs.append(scan_solver.solve_final(dyadic_refine(inc, dyadic_order),
                                            naive))
    return torch.cat(outs)


def _check(X, Y, ii, jj):
    for name, t in (("X", X), ("Y", Y)):
        if t.device.type != "cuda":
            raise ValueError(f"rbf_gen_solve_final: {name} is on {t.device}")
        if t.dtype not in _FNS:
            raise ValueError(f"rbf_gen_solve_final: {name} has dtype "
                             f"{t.dtype}; expected torch.float32 or "
                             "torch.float64")
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"rbf_gen_solve_final: {name} must be a "
                             "contiguous (batch, length, dim) tensor")
    if X.device != Y.device or X.dtype != Y.dtype or X.shape[2] != Y.shape[2]:
        raise ValueError("rbf_gen_solve_final: X and Y differ in device, "
                         "dtype or dim")
    if ii.dim() != 1 or ii.shape != jj.shape:
        raise ValueError("rbf_gen_solve_final: ii and jj must be 1-D and of "
                         "equal length")
    if ii.device != X.device or jj.device != X.device:
        raise ValueError("rbf_gen_solve_final: ii and jj must be on the "
                         "paths' device")


def rbf_gen_solve_final(X, Y, ii, jj, sigma, dyadic_order: int = 0,
                        naive: bool = False) -> torch.Tensor:
    """RBF signature kernel of the pairs ``(X[ii[p]], Y[jj[p]])`` -> ``(P,)``.

    ``X``: ``(A, M, D)``, ``Y``: ``(B, N, D)``; ``sigma`` a number or a
    0-d tensor (passed to the kernel by value).
    """
    if X.device.type == "cpu":
        return rbf_gen_solve_final_plain(X, Y, ii, jj, sigma, dyadic_order,
                                         naive)
    _check(X, Y, ii, jj)
    P, M, N = ii.shape[0], X.shape[1], Y.shape[1]
    if P == 0 or M < 2 or N < 2:
        # no pairs, or a length-1 path (K is its boundary, 1): no launch
        return X.new_ones(P)
    if P >= 2 ** 31:
        raise ValueError(f"rbf_gen_solve_final: {P} pairs exceed one launch")
    ii = ii.to(torch.int64).contiguous()
    jj = jj.to(torch.int64).contiguous()
    lo_i, hi_i, lo_j, hi_j = torch.stack(
        [ii.min(), ii.max(), jj.min(), jj.max()]).tolist()
    if lo_i < 0 or lo_j < 0 or hi_i >= X.shape[0] or hi_j >= Y.shape[0]:
        raise ValueError("rbf_gen_solve_final: pair index out of range")
    # the shorter refined side is the kernel's diagonal axis
    rows, ri, cols, ci = (X, ii, Y, jj) if M <= N else (Y, jj, X, ii)
    f = 2 ** dyadic_order
    _build.check_rows((rows.shape[1] - 1) * f, X.element_size(),
                      "rbf_gen_solve_final")
    out = torch.empty(P, dtype=X.dtype, device=X.device)
    fn = getattr(_build.library(), _FNS[X.dtype])
    device, stream = _build.stream_args(X)
    _build.check(fn(rows.data_ptr(), cols.data_ptr(), ri.data_ptr(),
                    ci.data_ptr(), out.data_ptr(), P, rows.shape[1],
                    cols.shape[1], X.shape[2], f, float(sigma), int(naive),
                    device, stream), "rbf_gen_wavefront")
    COUNTS[str(X.dtype).removeprefix("torch.")] += 1
    return out
