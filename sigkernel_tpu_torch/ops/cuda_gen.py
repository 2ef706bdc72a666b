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
linear-combination chunks without copying paths per pair. K1 and K1-stack
(:func:`rbf_gen_solve_stack`, which also writes the solution stack: the
stack outputs of ``solve_final_f32_gen_stack`` and
``solve_final_df_gen_stack``) are the band-pipelined wavefront of
``csrc/band_sweep.cuh`` with an RBF increment source: a block per (pair,
band of :data:`.cuda_blocked.BAND_ROWS` rows), each lane generating its base
row's increments once a base column from two cached G values
(:func:`rbf_gen_banded_plain` emulates it on any device, for the tests). No
row bound applies to them. A launch holds at most :func:`gen_chunk` pairs,
so that the bands' hand-off scratch stays within :data:`SCRATCH_BYTES`.

K3<gen> (:func:`rbf_gen_adjoint`) replaces ``pallas_adjoint.py``'s
``_product_collapse_planes_gen_kernel``,
``_product_collapse_planes_gen_df_kernel`` and
``_product_collapse_planes_gen32_kernel``: the reverse sweep with its
increments regenerated from the paths, the product with the stack and the
dyadic collapse, one block a pair within the row bound.

Each wrapper launches its kernel for CUDA tensors and takes its plain
version (``*_plain``) only for CPU tensors. ``COUNTS``, ``STACK_COUNTS`` and
``ADJOINT_COUNTS`` hold the kernel launches per dtype and the calls of the
plain versions.
"""
from __future__ import annotations

import torch

from . import _build, cuda_blocked, scan_solver
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
# K1's hand-off scratch a launch: (pairs, bands - 1, C + 1) values, with
# the launch's counters. 512 MiB holds ~2,185 pairs at length 1024, dyadic
# 1 in double (16 bands, C = 2,046: ~35,000 blocks, some 30 waves of the
# card), so a launch of more pairs would fill the card no better; it bounds
# what K1 adds to the peak.
SCRATCH_BYTES = 512 << 20


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


def _lane_increments(X, Y, ii, jj, sigma, f):
    """The refined increments ``(P, R, C)`` of each pair's frame as K1's
    lanes meet them: RbfSource's arithmetic (``csrc/rbf_gen.cuh``) on the
    band sweep's schedule (``csrc/band_sweep.cuh``). The pair is oriented
    with the shorter path as ``rows`` (transposed when ``M > N``); lane ``i``
    (frame row ``i`` from 1, lane ``t = (i - 1) % 32`` of its warp) owns
    base row ``ra = (i - 1) // f``: ``x_ra``, ``x_ra+1`` and their squared
    norms, and G of the last base column generated, so that its next column
    costs two new G values from one point of ``cols``. It generates columns
    0 and 1 first, then one column on each step ``s`` that is a multiple of
    ``f`` unless it holds one in reserve; at step ``s`` it sweeps column ``c
    = s - t`` with the current column's value and, after every ``f``
    columns, moves on to the next column and the reserve. Each sum starts at
    0 and runs over the coordinates in order, as in the kernel."""
    if X.shape[1] <= Y.shape[1]:
        xr, yc = X[ii], Y[jj]
    else:
        xr, yc = Y[jj], X[ii]
    P, Lr, D = xr.shape
    Cb = yc.shape[1] - 1
    R, C = (Lr - 1) * f, Cb * f
    dev = X.device
    i = torch.arange(1, R + 1, device=dev)
    t, ra = (i - 1) % cuda_blocked.WARP, (i - 1) // f
    x0, x1 = xr[:, ra], xr[:, ra + 1]  # (P, R, D)
    sig = torch.as_tensor(sigma_value(sigma), dtype=X.dtype, device=dev)
    zero = x0.new_zeros(P, R)
    sx0, sx1 = zero, zero
    for d in range(D):
        sx0, sx1 = sx0 + x0[..., d] * x0[..., d], sx1 + x1[..., d] * x1[..., d]

    def column(b):  # G(ra, b) and G(ra + 1, b), b (R,) a point per lane
        y = yc[:, b.clamp(max=Cb)]
        dot0 = dot1 = sy = zero
        for d in range(D):
            dot0 = dot0 + x0[..., d] * y[..., d]
            dot1 = dot1 + x1[..., d] * y[..., d]
            sy = sy + y[..., d] * y[..., d]
        return (torch.exp(-((sx0 + sy) - 2.0 * dot0) / sig),
                torch.exp(-((sx1 + sy) - 2.0 * dot1) / sig))

    g0, g1 = column(torch.zeros_like(i))
    nxt = torch.zeros_like(i)  # the next base column each lane generates

    def col(ask):
        """The increment of each asking lane's next column (0 past the last
        one, which leaves the cache as it is)."""
        nonlocal g0, g1, nxt
        g0n, g1n = column(nxt + 1)
        v = ((g1n + g0) - (g1 + g0n)) * (1.0 / (f * f))
        ok = ask & (nxt < Cb)
        g0, g1 = torch.where(ok, g0n, g0), torch.where(ok, g1n, g1)
        nxt = torch.where(ask, nxt + 1, nxt)
        return torch.where(nxt <= Cb, v, torch.zeros_like(v))

    everyone = torch.ones_like(i, dtype=torch.bool)
    u = col(everyone)
    u_next = col(everyone)
    u_more, more = torch.zeros_like(u), torch.zeros_like(everyone)
    out = u.new_zeros(P, R, C)
    for s in range(1, C + cuda_blocked.WARP):
        if s % f == 0:  # a uniform step: lanes with no reserve generate
            ask = ~more
            u_more = torch.where(ask, col(ask), u_more)
            more = more | ask
        c = s - t
        on = (c >= 1) & (c <= C)
        out[:, on, c[on] - 1] = u[:, on]
        wrap = on & (c % f == 0)
        u = torch.where(wrap, u_next, u)
        u_next = torch.where(wrap, u_more, u_next)
        more = more & ~wrap
    return out


def _banded(X, Y, ii, jj, sigma, dyadic_order, naive, H, Wc, stack):
    f = 2 ** dyadic_order
    u = _lane_increments(X, Y, ii, jj, sigma, f)
    ones = u.new_ones(u.shape[0], u.shape[2] + 1)  # row 0 is the constant 1
    return cuda_blocked.banded_sweep(u, ones, naive, H, Wc, stack)


def rbf_gen_banded_plain(X, Y, ii, jj, sigma, dyadic_order: int = 0,
                         naive: bool = False, H=cuda_blocked.BAND_ROWS,
                         Wc=cuda_blocked.CHUNK) -> torch.Tensor:
    """K1's own arithmetic in plain PyTorch, for the tests: each pair's
    frame swept in bands of ``H`` rows and chunks of ``Wc`` columns
    (:func:`.cuda_blocked.banded_sweep`) from a row 0 of 1s, the increments
    generated lane by lane (:func:`_lane_increments`); the corners ``(P,)``.
    Bit for bit :func:`rbf_gen_solve_final_plain`; no route runs it."""
    if ii.shape[0] == 0 or X.shape[1] < 2 or Y.shape[1] < 2:
        return X.new_ones(ii.shape[0])
    return _banded(X, Y, ii, jj, sigma, dyadic_order, naive, H, Wc,
                   False)[:, -1].clone()


def rbf_gen_banded_stack_plain(X, Y, ii, jj, sigma, dyadic_order: int = 0,
                               naive: bool = False, H=cuda_blocked.BAND_ROWS,
                               Wc=cuda_blocked.CHUNK):
    """K1-stack's own arithmetic, as :func:`rbf_gen_banded_plain`:
    ``(values, stack)``, the stack written as the band kernel writes it.
    Bit for bit :func:`rbf_gen_solve_stack_plain`."""
    bottom, stk = _banded(X, Y, ii, jj, sigma, dyadic_order, naive, H, Wc,
                          True)
    return bottom[:, -1].clone(), stk


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


def _oriented(X, Y, ii, jj, dyadic_order, what, bounded=True):
    """The shorter refined side is the kernels' diagonal axis: ``(rows,
    row indices, cols, col indices, f, transposed)``. ``bounded``: the
    kernel keeps a ring of three diagonals in shared memory (K3<gen>), so
    the rows are checked against :func:`._build.max_rows`."""
    f = 2 ** dyadic_order
    if X.shape[1] <= Y.shape[1]:
        rows, ri, cols, ci, transposed = X, ii, Y, jj, 0
    else:
        rows, ri, cols, ci, transposed = Y, jj, X, ii, 1
    if bounded:
        _build.check_rows((rows.shape[1] - 1) * f, X.element_size(), what)
    return rows, ri, cols, ci, f, transposed


def gen_chunk(P: int, R: int, C: int, itemsize: int) -> int:
    """Pairs a K1 launch: all ``P`` while one band holds the frame's ``R``
    rows (no scratch), else as many as keep the bands' hand-off scratch
    and the launch's counters (an int a block, and the ticket) within
    :data:`SCRATCH_BYTES` (at least one)."""
    nbands = -(-R // cuda_blocked.BAND_ROWS)
    if nbands <= 1:
        return max(P, 1)
    per_pair = (nbands - 1) * (C + 1) * itemsize + 4 * nbands
    return max(1, min(P, (SCRATCH_BYTES - 4) // per_pair))


def _launch_banded(what, fns, counts, X, Y, ii, jj, sigma, dyadic_order,
                   naive, out, stack=None):
    """K1 or K1-stack (``stack`` given) over the pairs in launches of
    :func:`gen_chunk` pairs, each with its scratch and freshly zeroed
    counters (reused across the launches, on one stream)."""
    rows, ri, cols, ci, f, _ = _oriented(X, Y, ii, jj, dyadic_order, what,
                                         bounded=False)
    P, Lr, Lc = ii.shape[0], rows.shape[1], cols.shape[1]
    R, C = (Lr - 1) * f, (Lc - 1) * f
    nbands = -(-R // cuda_blocked.BAND_ROWS)
    chunk = gen_chunk(P, R, C, X.element_size())
    scratch = torch.empty(chunk * (nbands - 1) * (C + 1), dtype=X.dtype,
                          device=X.device)
    counters = torch.empty(chunk * nbands + 1, dtype=torch.int32,
                           device=X.device)
    per_stack = (R + C + 1) * (R + 1) * X.element_size()
    item = out.element_size()
    for s in range(0, P, chunk):
        n = min(chunk, P - s)
        counters.zero_()
        at = (rows.data_ptr(), cols.data_ptr(), ri.data_ptr() + 8 * s,
              ci.data_ptr() + 8 * s, out.data_ptr() + item * s)
        if stack is not None:
            at += (stack.data_ptr() + per_stack * s,)
        _build.launch(what, fns, counts, X, *at, scratch.data_ptr(),
                      counters.data_ptr(), n, Lr, Lc, X.shape[2], f,
                      sigma_value(sigma), nbands, int(naive))


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
    out = torch.empty(P, dtype=X.dtype, device=X.device)
    _launch_banded("rbf_gen_wavefront", _FNS, COUNTS, X, Y, ii, jj, sigma,
                   dyadic_order, naive, out)
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
    f = 2 ** dyadic_order
    out = torch.empty(P, dtype=X.dtype, device=X.device)
    stack = torch.empty(stack_shape(P, (M - 1) * f, (N - 1) * f),
                        dtype=X.dtype, device=X.device)
    if P:
        _launch_banded("rbf_gen_stack", _STACK_FNS, STACK_COUNTS, X, Y, ii,
                       jj, sigma, dyadic_order, naive, out, stack)
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
