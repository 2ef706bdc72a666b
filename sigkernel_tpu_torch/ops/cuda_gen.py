"""K1: the RBF-generation wavefront (``csrc/rbf_gen_wavefront.cu``), its
stack-emitting instance, and K3<gen>, the adjoint with the same generation
(``csrc/adjoint_collapse.cu``).

K1 replaces the value path of ``sigkernel_tpu/ops/pallas_gen32.py``
(``_wavefront_f32_gen_kernel``), ``sigkernel_tpu/ops/pallas_df64.py``
(``_wavefront_df_gen_kernel``) and ``sigkernel_tpu/ops/pallas_fused.py``
(``_fused_rbf_kernel``, ``_fused_rbf_dyadic_kernel``): the RBF signature
kernel ``k_sig(X[ii[p]], Y[jj[p]])`` of each pair ``p``, with the increments
``dd(exp(-|x - y|^2 / sigma))`` generated in the kernel from the path points.
Nothing but paths goes in and values come out; the pair index arrays let one
kernel serve pairwise kernels, Grams, the symmetric triangle and the
linear-combination chunks without copying paths per pair. On the H100 it is
bound by arithmetic and ``exp``: four ``exp`` per refined cell in this
simple form.

K1-stack (:func:`rbf_gen_solve_stack`) also writes the solution stack (the
stack outputs of ``solve_final_f32_gen_stack`` and
``solve_final_df_gen_stack``). K3<gen> (:func:`rbf_gen_adjoint`) replaces
``pallas_adjoint.py``'s ``_product_collapse_planes_gen_kernel``,
``_product_collapse_planes_gen_df_kernel`` and
``_product_collapse_planes_gen32_kernel``: the reverse sweep with its
increments regenerated from the paths, the product with the stack and the
dyadic collapse.

Each wrapper launches its kernel for CUDA tensors and takes its plain
version (``*_plain``) only for CPU tensors. ``COUNTS``, ``STACK_COUNTS`` and
``ADJOINT_COUNTS`` hold the kernel launches per dtype and the calls of the
plain versions.
"""
from __future__ import annotations

import torch

from . import _build, scan_solver
from .cuda_solver import stack_shape
from ..utils import dyadic_refine

COUNTS = {"float32": 0, "float64": 0, "plain": 0}
STACK_COUNTS = {"float32": 0, "float64": 0, "plain": 0}
ADJOINT_COUNTS = {"float32": 0, "float64": 0, "plain": 0}

_FNS = {torch.float32: "sk_rbf_gen_wavefront_f32",
        torch.float64: "sk_rbf_gen_wavefront_f64"}
_STACK_FNS = {torch.float32: "sk_rbf_gen_stack_f32",
              torch.float64: "sk_rbf_gen_stack_f64"}
_ADJOINT_FNS = {torch.float32: "sk_adjoint_gen_f32",
                torch.float64: "sk_adjoint_gen_f64"}

# the plain version solves pairs in chunks whose refined grids stay near this
_PLAIN_CHUNK_BYTES = 1 << 30


def sigma_value(sigma) -> float:
    """``sigma`` (a number or a 0-d tensor, which may require a gradient) as
    the double the kernels take by value."""
    if isinstance(sigma, torch.Tensor):
        sigma = sigma.detach()
    return float(sigma)


def sqdist(x, y) -> torch.Tensor:
    """``|x_m - y_n|^2`` of the pairs ``(x[p], y[p])`` -> ``(P, M, N)``, in
    the kernels' op order: ``(|x|^2 + |y|^2) - 2 <x, y>`` with each sum
    taken over the coordinates in order."""
    xy = x[:, :, None, :] * y[:, None, :, :]
    xx, yy = x * x, y * y
    dot, sx, sy = xy[..., 0], xx[..., 0], yy[..., 0]
    for d in range(1, x.shape[-1]):
        dot, sx, sy = dot + xy[..., d], sx + xx[..., d], sy + yy[..., d]
    return (sx[:, :, None] + sy[:, None, :]) - 2.0 * dot


def gen_increments(x, y, sigma) -> torch.Tensor:
    """The base increment grids ``(P, M-1, N-1)`` of the pairs ``(x[p], y[p])``
    in the kernel's op order: ``G = exp(-sqdist / sigma)``, then
    ``(g11 + g00) - (g10 + g01)``.

    The same quantity as ``double_difference(RBFKernel(sigma).batch_kernel(x,
    y))``; the op order is the kernel's so that the float32 check on the card
    compares like with like (other orders move float32 values by up to 1e-3
    at length 1024, dyadic 2).
    """
    sigma = torch.as_tensor(sigma_value(sigma), dtype=x.dtype,
                            device=x.device)
    G = torch.exp(-sqdist(x, y) / sigma)
    return (G[:, 1:, 1:] + G[:, :-1, :-1]) - (G[:, 1:, :-1] + G[:, :-1, 1:])


def plain_chunk(X, Y, dyadic_order: int, grids: int) -> int:
    """Pairs per chunk of a plain version that holds ``grids`` refined
    grids per pair."""
    f = 2 ** dyadic_order
    M, N, D = X.shape[1], Y.shape[1], X.shape[2]
    per_pair = (M * N * (D + 4)
                + grids * f * f * max(M - 1, 0) * max(N - 1, 0)) \
        * X.element_size()
    return max(1, _PLAIN_CHUNK_BYTES // max(per_pair, 1))


def rbf_gen_solve_final_plain(X, Y, ii, jj, sigma, dyadic_order: int = 0,
                              naive: bool = False) -> torch.Tensor:
    """Plain version: per pair the RBF increments (:func:`gen_increments`)
    -> dyadic refinement -> the plain anti-diagonal loop."""
    COUNTS["plain"] += 1
    chunk = plain_chunk(X, Y, dyadic_order, 2)
    outs = [X.new_empty(0)]
    for s in range(0, ii.shape[0], chunk):
        inc = gen_increments(X[ii[s:s + chunk]], Y[jj[s:s + chunk]], sigma)
        outs.append(scan_solver.solve_final(dyadic_refine(inc, dyadic_order),
                                            naive))
    return torch.cat(outs)


def rbf_gen_solve_stack_plain(X, Y, ii, jj, sigma, dyadic_order: int = 0,
                              naive: bool = False):
    """Plain version of K1-stack: the plain grid of each pair, laid out as
    the stack -> ``(values, stack)``."""
    STACK_COUNTS["plain"] += 1
    inc = gen_increments(X[ii], Y[jj], sigma)
    grid = scan_solver.solve_grid(dyadic_refine(inc, dyadic_order), naive)
    # clone: a view of the corner would keep the whole grid alive
    return grid[..., -1, -1].clone(), scan_solver.grid_to_stack(grid)


def rbf_gen_adjoint_plain(X, Y, ii, jj, sigma, stack, dyadic_order: int = 0,
                          naive: bool = False) -> torch.Tensor:
    """Plain version of K3<gen>: the increments regenerated from the paths,
    then :func:`.scan_solver.adjoint_from_stack`."""
    ADJOINT_COUNTS["plain"] += 1
    inc = gen_increments(X[ii], Y[jj], sigma)
    return scan_solver.adjoint_from_stack(dyadic_refine(inc, dyadic_order),
                                          stack, 2 ** dyadic_order, naive)


def check_pairs(X, Y, ii, jj, what):
    """Check a launch's inputs; returns the index arrays as contiguous
    int64."""
    for name, t in (("X", X), ("Y", Y)):
        if t.device.type != "cuda":
            raise ValueError(f"{what}: {name} is on {t.device}")
        if t.dtype not in _FNS:
            raise ValueError(f"{what}: {name} has dtype {t.dtype}; expected "
                             "torch.float32 or torch.float64")
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous (batch, "
                             "length, dim) tensor")
    if X.device != Y.device or X.dtype != Y.dtype or X.shape[2] != Y.shape[2]:
        raise ValueError(f"{what}: X and Y differ in device, dtype or dim")
    if ii.dim() != 1 or ii.shape != jj.shape:
        raise ValueError(f"{what}: ii and jj must be 1-D and of equal length")
    if ii.device != X.device or jj.device != X.device:
        raise ValueError(f"{what}: ii and jj must be on the paths' device")
    if ii.shape[0] >= 2 ** 31:
        raise ValueError(f"{what}: {ii.shape[0]} pairs exceed one launch")
    ii = ii.to(torch.int64).contiguous()
    jj = jj.to(torch.int64).contiguous()
    if ii.shape[0]:
        lo_i, hi_i, lo_j, hi_j = torch.stack(
            [ii.min(), ii.max(), jj.min(), jj.max()]).tolist()
        if lo_i < 0 or lo_j < 0 or hi_i >= X.shape[0] or hi_j >= Y.shape[0]:
            raise ValueError(f"{what}: pair index out of range")
    return ii, jj


def _oriented(X, Y, ii, jj, dyadic_order, what):
    """The shorter refined side is the kernels' diagonal axis: ``(rows,
    row indices, cols, col indices, f, transposed)``."""
    f = 2 ** dyadic_order
    if X.shape[1] <= Y.shape[1]:
        rows, ri, cols, ci, transposed = X, ii, Y, jj, 0
    else:
        rows, ri, cols, ci, transposed = Y, jj, X, ii, 1
    _build.check_rows((rows.shape[1] - 1) * f, X.element_size(), what)
    return rows, ri, cols, ci, f, transposed


def rbf_gen_solve_final(X, Y, ii, jj, sigma, dyadic_order: int = 0,
                        naive: bool = False) -> torch.Tensor:
    """RBF signature kernel of the pairs ``(X[ii[p]], Y[jj[p]])`` -> ``(P,)``.

    ``X``: ``(A, M, D)``, ``Y``: ``(B, N, D)``; ``sigma`` a number or a
    0-d tensor (passed to the kernel by value).
    """
    if X.device.type == "cpu":
        return rbf_gen_solve_final_plain(X, Y, ii, jj, sigma, dyadic_order,
                                         naive)
    ii, jj = check_pairs(X, Y, ii, jj, "rbf_gen_solve_final")
    P, M, N = ii.shape[0], X.shape[1], Y.shape[1]
    if P == 0 or M < 2 or N < 2:
        # no pairs, or a length-1 path (K is its boundary, 1): no launch
        return X.new_ones(P)
    rows, ri, cols, ci, f, _ = _oriented(X, Y, ii, jj, dyadic_order,
                                         "rbf_gen_solve_final")
    out = torch.empty(P, dtype=X.dtype, device=X.device)
    _build.launch("rbf_gen_wavefront", _FNS, COUNTS, X, rows.data_ptr(),
                  cols.data_ptr(), ri.data_ptr(), ci.data_ptr(),
                  out.data_ptr(), P, rows.shape[1], cols.shape[1], X.shape[2],
                  f, sigma_value(sigma), int(naive))
    return out


def rbf_gen_solve_stack(X, Y, ii, jj, sigma, dyadic_order: int = 0,
                        naive: bool = False):
    """K1-stack: ``(values (P,), stack)`` of the pairs ``(X[ii[p]],
    Y[jj[p]])``; the stack is ``cuda_solver.stack_shape(P, (M-1) f,
    (N-1) f)``. Needs paths of length >= 2 (a length-1 path has no adjoint
    to feed)."""
    if X.device.type == "cpu":
        return rbf_gen_solve_stack_plain(X, Y, ii, jj, sigma, dyadic_order,
                                         naive)
    ii, jj = check_pairs(X, Y, ii, jj, "rbf_gen_solve_stack")
    P, M, N = ii.shape[0], X.shape[1], Y.shape[1]
    if M < 2 or N < 2:
        raise ValueError("rbf_gen_solve_stack: a length-1 path has no stack")
    rows, ri, cols, ci, f, _ = _oriented(X, Y, ii, jj, dyadic_order,
                                         "rbf_gen_solve_stack")
    out = torch.empty(P, dtype=X.dtype, device=X.device)
    stack = torch.empty(stack_shape(P, (M - 1) * f, (N - 1) * f),
                        dtype=X.dtype, device=X.device)
    if P:
        _build.launch("rbf_gen_stack", _STACK_FNS, STACK_COUNTS, X,
                      rows.data_ptr(), cols.data_ptr(), ri.data_ptr(),
                      ci.data_ptr(), out.data_ptr(), stack.data_ptr(), P,
                      rows.shape[1], cols.shape[1], X.shape[2], f,
                      sigma_value(sigma), int(naive))
    return out, stack


def rbf_gen_adjoint(X, Y, ii, jj, sigma, stack, dyadic_order: int = 0,
                    naive: bool = False) -> torch.Tensor:
    """K3<gen>: the gradient ``(P, M-1, N-1)`` of each pair's value in its
    base RBF increments, given the forward ``stack`` of
    :func:`rbf_gen_solve_stack` (unit upstream cotangent; the caller scales
    by its ``g``)."""
    if X.device.type == "cpu":
        return rbf_gen_adjoint_plain(X, Y, ii, jj, sigma, stack,
                                     dyadic_order, naive)
    ii, jj = check_pairs(X, Y, ii, jj, "rbf_gen_adjoint")
    P, M, N = ii.shape[0], X.shape[1], Y.shape[1]
    ct = torch.zeros(P, max(M - 1, 0), max(N - 1, 0), dtype=X.dtype,
                     device=X.device)
    if P == 0 or M < 2 or N < 2:
        return ct
    rows, ri, cols, ci, f, transposed = _oriented(X, Y, ii, jj, dyadic_order,
                                                  "rbf_gen_adjoint")
    want = stack_shape(P, (M - 1) * f, (N - 1) * f)
    if (stack.shape != want or stack.dtype != X.dtype
            or stack.device != X.device or not stack.is_contiguous()):
        raise ValueError(f"rbf_gen_adjoint: stack must be a contiguous {want}"
                         " tensor of the paths' dtype and device")
    _build.launch("adjoint_collapse_gen", _ADJOINT_FNS, ADJOINT_COUNTS, X,
                  rows.data_ptr(), cols.data_ptr(), ri.data_ptr(),
                  ci.data_ptr(), stack.data_ptr(), ct.data_ptr(), P,
                  rows.shape[1], cols.shape[1], X.shape[2], f,
                  sigma_value(sigma), transposed, int(naive))
    return ct / (f * f)
