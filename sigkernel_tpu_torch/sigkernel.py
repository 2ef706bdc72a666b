"""Signature-kernel estimators: the public API of the port.

Counterpart of :mod:`sigkernel_tpu.sigkernel` with the same signatures:
``sig_kernel``, ``sig_gram`` (with the ``sym`` triangle), ``sig_gram_lincomb``,
``sig_mmd``, ``sig_distance``, the scoring rules, the derivative Gram
(``sig_kernel_and_derivatives_gram``, ``k_kgrad``) and the ``SigKernel``
module. Each tile's solver family and gradient dtype come from
:func:`.ops.routes.resolve`:

- ``gen``: RBF increments generated in the K1 kernel from the paths and the
  pair index arrays (no path copies per pair, no increment grid). Gradients
  through :class:`_RBFGen`, whose backward recomputes each chunk's forward
  stack (K1-stack), runs the adjoint (K3<gen>) and the increment-chain VJP
  (K4) to the paths and ``sigma``. The kernels take ``sigma`` by value,
  read on the host once before the estimator's launches
  (:func:`_launch_sigma`), and the pair indices as the estimator built
  them, with no read of their bounds: between its launches the host reads
  nothing, so it runs ahead of the card.
- ``lgen``: Linear increments generated in the K6 kernel from the paths'
  increments and the pair index arrays. Gradients through
  :class:`_LinearGen`, whose backward writes each chunk's increment grid
  by K10, runs the ``inc`` family's adjoint on it (K2-stack, K3<inc>) and
  maps its cotangent to the increments by K11, with no autograd.
- ``inc``/``scan``: ``double_difference`` of the static-kernel Gram in torch,
  solved by the K2 kernel (K7 stripes past the row bound) or the plain loop
  (:func:`.ops.solve.solve`, whose adjoint backward is the ``inc`` tier's or
  the plain grid route); autograd carries the gradient through the Gram to
  the paths and the kernel's hyper-parameters. On the ``inc`` family a
  gradient goes through :class:`_GridPairs` instead, which builds each
  chunk's grid in the forward and again in the backward, so no tile keeps
  its grids alive: for exactly ``RBFKernel`` the K9 kernel writes the grid
  from the paths and K4 carries its cotangent to the paths and ``sigma``;
  for exactly ``LinearKernel`` K10 writes it from the scaled increments and
  K11 carries its cotangent to them, with no autograd; any other static
  kernel builds it in torch and differentiates it by autograd.

Every estimator is differentiable in ``X``, ``Y``, ``W`` and the static
kernel's hyper-parameter (``RBFKernel.sigma`` or ``LinearKernel.scale``, a
buffer that may have ``requires_grad``). ``grad_solver`` sets the gradient's
grade (see :mod:`.ops.routes`). :func:`sig_gram_lincomb` computes its
gradients eagerly, chunk by chunk, in its forward (:class:`_GramLincomb`),
so memory stays one chunk's stack at any Gram size.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from . import kernels as _kernels
from .ops import cuda_deriv, cuda_gen, cuda_lgen, incvjp, routes, scan_solver
from .ops.solve import inc_route_bwd, inc_route_fwd, solve
from .tracing import span, spanned
from .utils import double_difference, dyadic_refine, pad_length


def _prepare(static_kernel, X, Y, length_bucket, grad_solver):
    routes.check_grad_solver(grad_solver)
    if length_bucket:
        X = pad_length(X, length_bucket)
        Y = pad_length(Y, length_bucket)
    return X.contiguous(), Y.contiguous()


def _hyper(static_kernel):
    """The static kernel's hyper-parameter tensors (its pytree leaves)."""
    return tuple(static_kernel.parameters()) + tuple(static_kernel.buffers())


def _refined(X, Y, dyadic_order):
    """The refined grid ``(MM, NN)`` of the pairs of ``X`` and ``Y``: the
    shape the route gates read."""
    f = 2 ** dyadic_order
    return max(X.shape[1] - 1, 0) * f, max(Y.shape[1] - 1, 0) * f


def _need_grad(static_kernel, X, Y):
    """Will autograd ask for a gradient of the pairs of ``X`` and ``Y``?"""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in (X, Y) + _hyper(static_kernel))


def _family(static_kernel, X, Y, dyadic_order, solver, grad_solver,
            need_grad):
    """The family of the pairs of ``X`` and ``Y``, from their refined shape
    and whether autograd will ask for a gradient."""
    return routes.resolve_family(
        static_kernel, X.device.type, solver,
        shape=_refined(X, Y, dyadic_order), dtype=X.dtype,
        grad_solver=grad_solver, need_grad=need_grad)


def _require_rbf(static_kernel):
    # the gen gradient formulas (K3<gen>, K4) are the RBF kernel's own
    if type(static_kernel) is not _kernels.RBFKernel:
        raise TypeError("the generation route's gradient is RBFKernel's; "
                        f"got {type(static_kernel).__name__}")


def _launch_sigma(static_kernel) -> float:
    """The RBF kernel's ``sigma`` as the number the generator family's
    kernels take by value (each casts it to the paths' dtype). Read once
    before the launches it serves, each :func:`_pairs` call (a Gram's tile
    or chunk, a batch of :func:`sig_kernel`) and each
    :class:`_GramLincomb`, and handed down to all of them: a ``sigma`` on
    the card costs one ``sk.sync.sigma`` wait there, not one a launch."""
    _require_rbf(static_kernel)
    return cuda_gen.sigma_value(static_kernel.sigma)


def _gen_backward(X, Y, ii, jj, sigma, g, bwd_dtype, dyadic_order, naive,
                  stack=None):
    """``(d sigma, dX, dY)`` of ``sum_p g_p k(X[ii_p], Y[jj_p])`` for the RBF
    kernel, in ``bwd_dtype``: per chunk K1-stack (skipped when the caller's
    forward already made ``stack``, in ``bwd_dtype``), K3<gen> with ``g``
    (applied in its kernel), then K4. ``sigma``: the number from
    :func:`_launch_sigma`. Its callers built ``ii`` and ``jj`` from the
    batch sizes, so no launch reads their bounds."""
    Xb = X.detach().to(bwd_dtype).contiguous()
    Yb = Y.detach().to(bwd_dtype).contiguous()
    ds, dX, dY = Xb.new_zeros(()), torch.zeros_like(Xb), torch.zeros_like(Yb)
    M, N, P = X.shape[1], Y.shape[1], ii.shape[0]
    if M < 2 or N < 2 or P == 0:
        return ds, dX, dY
    f = 2 ** dyadic_order
    chunk = P if stack is not None else routes.chunk_pairs(
        P, routes.tier_bytes("full", ((M - 1) * f, (N - 1) * f),
                             Xb.element_size()))
    for s in range(0, P, chunk):
        with span("sk.est.chunk"):
            ic, jc = ii[s:s + chunk], jj[s:s + chunk]
            stk = stack
            if stk is None:
                _, stk = cuda_gen.rbf_gen_solve_stack(
                    Xb, Yb, ic, jc, sigma, dyadic_order, naive, in_range=True)
            ct = cuda_gen.rbf_gen_adjoint(Xb, Yb, ic, jc, sigma, stk,
                                          dyadic_order, naive,
                                          g=g[s:s + chunk].to(bwd_dtype),
                                          in_range=True)
            del stk
            e, dx, dy = incvjp.rbf_dd_vjp(Xb, Yb, ic, jc, sigma, ct,
                                          in_range=True)
            ds, dX, dY = ds + e, dX + dx, dY + dy
    return ds, dX, dY


class _RBFGen(torch.autograd.Function):
    """``k_sig(X[ii[p]], Y[jj[p]])`` on the ``gen`` family: paths, sigma and
    pair indices in, values out. The forward keeps only its inputs; the
    backward recomputes each chunk's stack, so residual memory does not grow
    with the pair count (the JAX ``adjoint_planes_gen_df`` design). Applied
    by :func:`_pairs` alone, whose callers build the indices, so no launch
    reads their bounds; ``sv`` is ``sigma``'s value (:func:`_launch_sigma`),
    which the forward's and the backward's launches take."""

    @staticmethod
    def forward(ctx, X, Y, sigma, ii, jj, cfg, sv):
        static_kernel, dyadic_order, naive, solver, grad_solver = cfg
        _require_rbf(static_kernel)
        ctx.save_for_backward(X, Y, sigma, ii, jj)
        ctx.cfg, ctx.sv = cfg, sv
        return cuda_gen.rbf_gen_solve_final(X, Y, ii, jj, sv, dyadic_order,
                                            naive, in_range=True)

    @staticmethod
    def backward(ctx, g):
        X, Y, sigma, ii, jj = ctx.saved_tensors
        static_kernel, dyadic_order, naive, solver, grad_solver = ctx.cfg
        route = routes.resolve(static_kernel, X.device.type, solver, X.dtype,
                               grad_solver, _refined(X, Y, dyadic_order),
                               need_grad=True)
        ds, dX, dY = _gen_backward(X, Y, ii, jj, ctx.sv, g, route.bwd_dtype,
                                   dyadic_order, naive)
        return (dX.to(X.dtype), dY.to(Y.dtype), ds.to(sigma), None, None,
                None, None)


def _grid_chunk(X, Y, P):
    """Pairs of one chunk whose base increment grids, built in ``X``'s
    dtype, fit :data:`.ops.routes.STACK_BYTES`."""
    return routes.chunk_pairs(P, routes.grid_bytes(
        max(X.shape[1] - 1, 0), max(Y.shape[1] - 1, 0), X.element_size()))


def _torch_grid(static_kernel, X, Y, ic, jc):
    """A chunk's base increment grids built in PyTorch,
    ``double_difference(batch_kernel(x, y))``, differentiable."""
    with span("sk.grid"):
        return double_difference(static_kernel.batch_kernel(X[ic], Y[jc]))


def _rbf_grid_backward(X, Y, ii, jj, sv, g, bwd_dtype, dyadic_order, naive):
    """``(d sigma, dX, dY)`` of ``sum_p g_p k(X[ii_p], Y[jj_p])`` for the RBF
    kernel on the ``inc`` family, in ``bwd_dtype``: per chunk the grids from
    the paths by K9, the increment-grid adjoint on them
    (:func:`.ops.solve.inc_route_bwd`), and K4 from their cotangent to the
    paths and ``sigma``. ``sv``: ``sigma``'s value (:func:`_launch_sigma`).
    The indices come from :func:`_pairs`' callers, so no launch reads their
    bounds."""
    Xb = X.detach().to(bwd_dtype).contiguous()
    Yb = Y.detach().to(bwd_dtype).contiguous()
    ds, dX, dY = Xb.new_zeros(()), torch.zeros_like(Xb), torch.zeros_like(Yb)
    P = ii.shape[0]
    chunk = _grid_chunk(X, Y, P)
    for s in range(0, P, chunk):
        with span("sk.est.chunk"):
            ic, jc = ii[s:s + chunk], jj[s:s + chunk]
            dd = cuda_gen.rbf_gen_increments(Xb, Yb, ic, jc, sv,
                                             in_range=True)
            ct = inc_route_bwd(dd, g[s:s + chunk], naive, dyadic_order)
            del dd
            e, dx, dy = incvjp.rbf_dd_vjp(Xb, Yb, ic, jc, sv, ct,
                                          in_range=True)
            ds, dX, dY = ds + e, dX + dx, dY + dy
    return ds, dX, dY


def _linear_grid_backward(X, Y, ii, jj, scale, g, bwd_dtype, dyadic_order,
                          naive):
    """``(d scale, dX, dY)`` of ``sum_p g_p k(X[ii_p], Y[jj_p])`` for the
    Linear kernel on the ``inc`` and ``lgen`` families, in ``bwd_dtype``:
    per chunk the grids from the scaled increments by K10, the
    increment-grid adjoint on them (:func:`.ops.solve.inc_route_bwd`), and
    K11 from their cotangent to the increments, scattered onto the paths'
    increments; then the increments' VJP to the paths and ``scale``
    (:func:`.ops.cuda_lgen.scaled_increments_vjp`). ``scale`` reaches the
    card only inside the scaled increments: no host read. The indices come
    from :func:`_pairs`' callers, so no launch reads their bounds."""
    Xb = X.detach().to(bwd_dtype).contiguous()
    Yb = Y.detach().to(bwd_dtype).contiguous()
    a = cuda_lgen.scaled_increments(Xb, scale)
    b = cuda_lgen.scaled_increments(Yb, scale)
    ua, vb = torch.zeros_like(a), torch.zeros_like(b)
    P = ii.shape[0]
    chunk = _grid_chunk(X, Y, P)
    for s in range(0, P, chunk):
        with span("sk.est.chunk"):
            ic, jc = ii[s:s + chunk], jj[s:s + chunk]
            dd = cuda_lgen.linear_gen_increments(a, b, ic, jc, in_range=True)
            ct = inc_route_bwd(dd, g[s:s + chunk], naive, dyadic_order)
            del dd
            u, v = cuda_lgen.linear_dd_vjp(a, b, ic, jc, ct, in_range=True)
            del ct
            ua.index_add_(0, ic, u)
            vb.index_add_(0, jc, v)
    dX, dsx = cuda_lgen.scaled_increments_vjp(Xb, scale, ua)
    dY, dsy = cuda_lgen.scaled_increments_vjp(Yb, scale, vb)
    return dsx + dsy, dX, dY


def _torch_grid_backward(static_kernel, X, Y, ii, jj, g, want, bwd_dtype,
                         dyadic_order, naive):
    """``(dX, dY, d want)`` by JAX's ``_pair_fused_bwd``: per chunk the grids
    built again in PyTorch under autograd, the increment-grid adjoint on
    them in ``bwd_dtype``, and ``torch.autograd.grad`` through the grids to
    ``X``, ``Y`` and the hyper-parameters ``want``."""
    Xd, Yd = X.detach().requires_grad_(), Y.detach().requires_grad_()
    acc = [torch.zeros_like(t) for t in [X, Y] + want]
    P = ii.shape[0]
    if not P or X.shape[1] < 2 or Y.shape[1] < 2:
        return acc
    chunk = _grid_chunk(X, Y, P)
    for s in range(0, P, chunk):
        with span("sk.est.chunk"):
            with torch.enable_grad():
                dd = _torch_grid(static_kernel, Xd, Yd, ii[s:s + chunk],
                                 jj[s:s + chunk])
            ct = inc_route_bwd(dd.detach().to(bwd_dtype).contiguous(),
                               g[s:s + chunk], naive, dyadic_order)
            grads = torch.autograd.grad(dd, [Xd, Yd] + want, ct.to(dd.dtype),
                                        allow_unused=True)
            for a, d in zip(acc, grads):
                if d is not None:
                    a += d
    return acc


class _GridPairs(torch.autograd.Function):
    """``k_sig(X[ii[p]], Y[jj[p]])`` on the ``inc`` family when a gradient
    is wanted: per chunk of pairs whose grids fit
    :data:`.ops.routes.STACK_BYTES`, the base increment grid is built,
    solved (K2, or K7 stripes past the row bound) and dropped. The backward
    builds each chunk's grid again and runs the increment-grid adjoint on it
    in the grade's dtype (:func:`.ops.solve.inc_route_bwd`: K2-stack +
    K3<inc>, K2-sparse + K8 or the striped adjoint), then carries the
    cotangent to ``X``, ``Y`` and the static kernel's hyper-parameters
    (``hyper``, its own tensors). Memory is one chunk's grids and stacks at
    any pair count, where autograd through a tile's Gram would keep three
    grids a pair of the whole tile alive.

    The grid and the cotangent's way back depend on the static kernel:

    - exactly ``RBFKernel``: ``sigma``'s value is read once, in the
      forward (:func:`_launch_sigma`), K9 writes the grids from the paths
      (:func:`.ops.cuda_gen.rbf_gen_increments`) and K4 maps the cotangent
      to the paths and ``sigma`` (:func:`.ops.incvjp.rbf_dd_vjp`), both in
      the grade's dtype, with no autograd (:func:`_rbf_grid_backward`);
    - exactly ``LinearKernel``: K10 writes the grids from the paths' scaled
      increments (:func:`.ops.cuda_lgen.linear_gen_increments`) and K11
      maps the cotangent to the increments
      (:func:`.ops.cuda_lgen.linear_dd_vjp`), both in the grade's dtype,
      then small PyTorch passes to the paths and ``scale``, with no
      autograd and no host read (:func:`_linear_grid_backward`);
    - any other: the grids built in PyTorch, ``double_difference(
      batch_kernel(x, y))``, and JAX's ``_pair_fused_bwd``, autograd through
      them (:func:`_torch_grid_backward`).

    On the card the ``index_add_`` of K4's and K11's outputs adds the pairs
    of a repeated path index by atomics, so ``dX`` and ``dY`` may differ in
    the last bits from run to run, as on the ``gen`` family, unless
    ``torch.use_deterministic_algorithms(True)`` is set."""

    @staticmethod
    def forward(ctx, X, Y, ii, jj, cfg, *hyper):
        static_kernel, dyadic_order, naive, _, _ = cfg
        ctx.save_for_backward(X, Y, ii, jj)
        # the RBF kernel's grids from K9, their cotangent to the paths by K4
        sv = (_launch_sigma(static_kernel)
              if type(static_kernel) is _kernels.RBFKernel else None)
        ctx.cfg, ctx.sv = cfg, sv
        # the Linear kernel's grids from K10, their cotangent by K11
        linear = type(static_kernel) is _kernels.LinearKernel
        if linear:
            a = cuda_lgen.scaled_increments(X, static_kernel.scale)
            b = cuda_lgen.scaled_increments(Y, static_kernel.scale)
        P = ii.shape[0]
        chunk = _grid_chunk(X, Y, P)
        vals = [X.new_empty(0)]
        for s in range(0, P, chunk):
            with span("sk.est.chunk"):
                ic, jc = ii[s:s + chunk], jj[s:s + chunk]
                if sv is not None:
                    dd = cuda_gen.rbf_gen_increments(X, Y, ic, jc, sv,
                                                     in_range=True)
                elif linear:
                    dd = cuda_lgen.linear_gen_increments(a, b, ic, jc,
                                                         in_range=True)
                else:
                    dd = _torch_grid(static_kernel, X, Y, ic, jc).contiguous()
                vals.append(inc_route_fwd(dd, naive, dyadic_order))
        return torch.cat(vals)

    @staticmethod
    def backward(ctx, g):
        X, Y, ii, jj = ctx.saved_tensors
        static_kernel, dyadic_order, naive, solver, grad_solver = ctx.cfg
        route = routes.resolve(static_kernel, X.device.type, solver, X.dtype,
                               grad_solver, _refined(X, Y, dyadic_order),
                               need_grad=True)
        needs = ctx.needs_input_grad[5:]
        if ctx.sv is not None:
            ds, dX, dY = _rbf_grid_backward(X, Y, ii, jj, ctx.sv, g,
                                            route.bwd_dtype, dyadic_order,
                                            naive)
            return (dX.to(X.dtype), dY.to(Y.dtype), None, None, None,
                    ds.to(static_kernel.sigma) if needs[0] else None)
        if type(static_kernel) is _kernels.LinearKernel:
            ds, dX, dY = _linear_grid_backward(X, Y, ii, jj,
                                               static_kernel.scale, g,
                                               route.bwd_dtype, dyadic_order,
                                               naive)
            return (dX.to(X.dtype), dY.to(Y.dtype), None, None, None,
                    ds.to(static_kernel.scale) if needs[0] else None)
        want = [h for h, n in zip(_hyper(static_kernel), needs) if n]
        dX, dY, *dh = _torch_grid_backward(static_kernel, X, Y, ii, jj, g,
                                           want, route.bwd_dtype,
                                           dyadic_order, naive)
        dh = iter(dh)
        return (dX, dY, None, None, None,
                *[next(dh) if n else None for n in needs])


class _LinearGen(_GridPairs):
    """``k_sig(X[ii[p]], Y[jj[p]])`` on the ``lgen`` family: K6 values from
    the paths, ``scale`` and the pair indices. The backward is
    :class:`_GridPairs`' for exactly ``LinearKernel``
    (:func:`_linear_grid_backward`): each chunk's grid written by K10 from
    the scaled increments, the increment-grid adjoint on it (K2-stack,
    K3<inc>), and K11 from its cotangent to the increments, then to ``X``,
    ``Y`` and ``scale``, with no autograd."""

    @staticmethod
    def forward(ctx, X, Y, ii, jj, cfg, *hyper):
        static_kernel, dyadic_order, naive, _, _ = cfg
        if type(static_kernel) is not _kernels.LinearKernel:
            raise TypeError("the Linear generation route is LinearKernel's; "
                            f"got {type(static_kernel).__name__}")
        ctx.save_for_backward(X, Y, ii, jj)
        ctx.cfg, ctx.sv = cfg, None
        # applied by _pairs alone, whose callers build ii and jj
        return cuda_lgen.linear_gen_solve_final(
            X, Y, ii, jj, static_kernel.scale.to(X), dyadic_order, naive,
            in_range=True)


def _pairs(static_kernel, X, Y, ii, jj, dyadic_order, naive, solver,
           grad_solver="auto"):
    """``k_sig(X[ii[p]], Y[jj[p]])`` per pair; ``ii = jj = None`` pairs
    ``X[p]`` with ``Y[p]`` (batches of one size, which :func:`sig_kernel`
    checks). Every caller builds ``ii`` and ``jj`` from the batch sizes of
    ``X`` and ``Y`` (``arange``, ``triu_indices``, :func:`_lincomb_pairs`),
    so no launch reads their bounds; on the ``gen`` family ``sigma`` is
    read once, here (:func:`_launch_sigma`)."""
    need_grad = _need_grad(static_kernel, X, Y)
    fam = _family(static_kernel, X, Y, dyadic_order, solver, grad_solver,
                  need_grad)
    if fam in ("gen", "lgen") or (fam == "inc" and need_grad):
        if ii is None:
            ii = jj = torch.arange(X.shape[0], device=X.device)
        cfg = (static_kernel, dyadic_order, naive, solver, grad_solver)
        if fam == "gen":
            sigma = static_kernel.sigma
            # held on the host (a number given to RBFKernel) and wanted
            # without a gradient: it stays there, as the launches take its
            # value and no gradient needs it on the card
            sigma = (sigma.to(X.dtype) if not need_grad
                     and sigma.device.type == "cpu" else sigma.to(X))
            return _RBFGen.apply(X, Y, sigma, ii, jj, cfg,
                                 _launch_sigma(static_kernel))
        fn = _LinearGen if fam == "lgen" else _GridPairs
        return fn.apply(X, Y, ii, jj, cfg, *_hyper(static_kernel))
    x = X if ii is None else X[ii]
    y = Y if jj is None else Y[jj]
    with span("sk.grid"):
        dd = double_difference(static_kernel.batch_kernel(x, y))
    return solve(dd, naive, solver, dyadic_order, grad_solver)


@spanned("sk.est.tile")
def _gram_tile(static_kernel, x, y, dyadic_order, naive, solver,
               grad_solver):
    """One ``(a, b)`` Gram tile."""
    a, b = x.shape[0], y.shape[0]
    need_grad = _need_grad(static_kernel, x, y)
    fam = _family(static_kernel, x, y, dyadic_order, solver, grad_solver,
                  need_grad)
    if fam in ("gen", "lgen") or (fam == "inc" and need_grad):
        ii = torch.arange(a, device=x.device).repeat_interleave(b)
        jj = torch.arange(b, device=x.device).repeat(a)
        return _pairs(static_kernel, x, y, ii, jj, dyadic_order, naive,
                      solver, grad_solver).reshape(a, b)
    with span("sk.grid"):
        dd = double_difference(static_kernel.Gram_matrix(x, y))
    return solve(dd, naive, solver, dyadic_order, grad_solver)


@spanned("sk.est.sig_kernel")
def sig_kernel(static_kernel, X, Y, dyadic_order=0, naive=False,
               solver="auto", max_batch: Optional[int] = 100,
               length_bucket: Optional[int] = None, grad_solver="auto"):
    """Pairwise signature kernel ``k_sig(X^i, Y^i)`` -> shape ``(batch,)``,
    solved ``max_batch`` pairs at a time."""
    X, Y = _prepare(static_kernel, X, Y, length_bucket, grad_solver)
    batch = X.shape[0]
    if Y.shape[0] != batch:
        # the pairs' indices are built from X's batch alone
        raise ValueError("sig_kernel pairs X[i] with Y[i]: X and Y must "
                         f"hold as many paths; got {batch} and {Y.shape[0]}")
    if max_batch is None or batch <= max_batch:
        return _pairs(static_kernel, X, Y, None, None, dyadic_order, naive,
                      solver, grad_solver)
    return torch.cat([
        _pairs(static_kernel, X[s:s + max_batch], Y[s:s + max_batch], None,
               None, dyadic_order, naive, solver, grad_solver)
        for s in range(0, batch, max_batch)])


def _gram_sym_triangle(static_kernel, X, dyadic_order, naive, solver,
                       max_batch, grad_solver):
    """Symmetric Gram ``G(X, X)``: solve exactly the ``A(A+1)/2`` upper
    triangle (the solve is transpose-covariant), ``max_batch**2`` pairs at a
    time, then mirror."""
    A = X.shape[0]
    iu, ju = torch.triu_indices(A, A, device=X.device)
    P = iu.shape[0]
    chunk = P if max_batch is None else min(max(max_batch, 1) ** 2, P)
    vals = [X.new_empty(0)]
    for s in range(0, P, chunk):
        with span("sk.est.chunk"):
            vals.append(_pairs(static_kernel, X, X, iu[s:s + chunk],
                               ju[s:s + chunk], dyadic_order, naive, solver,
                               grad_solver))
    K = X.new_zeros(A, A)
    K[iu, ju] = torch.cat(vals)
    return K + K.T - torch.diag(torch.diag(K))


@spanned("sk.est.sig_gram")
def sig_gram(static_kernel, X, Y, dyadic_order=0, sym=False, naive=False,
             solver="auto", max_batch: Optional[int] = 100,
             length_bucket: Optional[int] = None, grad_solver="auto"):
    """Signature-kernel Gram matrix ``k_sig(X^i, Y^j)`` -> ``(bx, by)``.

    ``sym=True`` (the caller asserts ``Y is X``) solves only the upper
    triangle and mirrors it. Otherwise the Gram is solved in
    ``max_batch x max_batch`` tiles.
    """
    X, Y = _prepare(static_kernel, X, Y, length_bucket, grad_solver)
    if sym and X.shape == Y.shape:
        return _gram_sym_triangle(static_kernel, X, dyadic_order, naive,
                                  solver, max_batch, grad_solver)
    bx, by = X.shape[0], Y.shape[0]
    mb = max(bx, by, 1) if max_batch is None else max_batch
    K = torch.cat([
        torch.cat([_gram_tile(static_kernel, X[a:a + mb], Y[b:b + mb],
                              dyadic_order, naive, solver, grad_solver)
                   for b in range(0, by, mb)], dim=1)
        for a in range(0, bx, mb)], dim=0)
    if sym:
        K = 0.5 * (K + K.T)
    return K


def _lincomb_pairs(A, B, W, sym):
    """Pair index lists + per-pair weights for ``sum(W * K)``; ``sym`` packs
    the upper triangle (``K`` is exactly symmetric)."""
    if sym:
        ii, jj = torch.triu_indices(A, A, device=W.device)
        w = W[ii, jj] + W[jj, ii].masked_fill(ii == jj, 0)
    else:
        k = torch.arange(A * B, device=W.device)
        ii, jj = k // B, k % B
        w = W.reshape(-1)
    return ii, jj, w


def _lincomb_value(static_kernel, X, Y, ii, jj, w, cfg):
    """The lincomb's value alone, chunk by chunk."""
    dyadic_order, naive, solver, grad_solver, chunk = cfg
    acc_dtype = torch.promote_types(w.dtype, X.dtype)
    S = torch.zeros((), dtype=acc_dtype, device=X.device)
    for s in range(0, ii.shape[0], chunk):
        with span("sk.est.chunk"):
            v = _pairs(static_kernel, X, Y, ii[s:s + chunk], jj[s:s + chunk],
                       dyadic_order, naive, solver, grad_solver)
            S = S + torch.sum(w[s:s + chunk] * v.to(acc_dtype))
    return S


def _chunk_grads_gen(static_kernel, X, Y, ic, jc, wc, route, cfg, sv):
    """One lincomb chunk on the ``gen`` family, kernels called directly, in
    sub-chunks whose stacks stay within ``routes.STACK_BYTES``: values and
    stack from one forward sweep (K1-stack; for a float32 grade on float64
    paths, K1 values plus a float32 K1-stack), then K3<gen> weighted by
    ``wc`` and K4. ``ic``, ``jc``: a chunk of :func:`_lincomb_pairs`'
    arrays, so no launch reads their bounds; ``sv``: ``sigma``'s value,
    read once a call (:func:`_launch_sigma`). Returns ``(values, dX, dY,
    (d sigma,))``."""
    dyadic_order, naive, _, _, _ = cfg
    bdt = route.bwd_dtype
    if X.shape[1] < 2 or Y.shape[1] < 2:
        v = cuda_gen.rbf_gen_solve_final(X, Y, ic, jc, sv, dyadic_order,
                                         naive, in_range=True)
        return v, torch.zeros_like(X), torch.zeros_like(Y), (
            torch.zeros_like(static_kernel.sigma),)
    Xb, Yb = X.to(bdt), Y.to(bdt)
    sub = routes.chunk_pairs(ic.shape[0], routes.tier_bytes(
        "full", _refined(X, Y, dyadic_order), Xb.element_size()))
    ds, dX, dY = Xb.new_zeros(()), torch.zeros_like(Xb), torch.zeros_like(Yb)
    vals = [X.new_empty(0)]
    for s in range(0, ic.shape[0], sub):
        with span("sk.est.chunk"):
            i, j = ic[s:s + sub], jc[s:s + sub]
            if bdt == X.dtype:
                v, stack = cuda_gen.rbf_gen_solve_stack(
                    X, Y, i, j, sv, dyadic_order, naive, in_range=True)
            else:
                v = cuda_gen.rbf_gen_solve_final(
                    X, Y, i, j, sv, dyadic_order, naive, in_range=True)
                _, stack = cuda_gen.rbf_gen_solve_stack(
                    Xb, Yb, i, j, sv, dyadic_order, naive, in_range=True)
            e, dx, dy = _gen_backward(Xb, Yb, i, j, sv, wc[s:s + sub], bdt,
                                      dyadic_order, naive, stack=stack)
            del stack
            vals.append(v)
            ds, dX, dY = ds + e, dX + dx, dY + dy
    return torch.cat(vals), dX, dY, (ds,)


def _chunk_grads_autograd(static_kernel, X, Y, ic, jc, wc, hyper, cfg):
    """One lincomb chunk on the ``inc``/``scan`` families: the chunk's
    weighted sum and its gradients by ``torch.autograd.grad`` (through the
    static kernel's Gram and :class:`.ops.solve._Solve`'s adjoint)."""
    dyadic_order, naive, solver, grad_solver, _ = cfg
    want = [h for h in hyper if h.requires_grad]
    with torch.enable_grad():
        Xd = X.detach().requires_grad_()
        Yd = Y.detach().requires_grad_()
        v = _pairs(static_kernel, Xd, Yd, ic, jc, dyadic_order, naive,
                   solver, grad_solver)
        s = torch.sum(wc * v.to(wc.dtype))
        grads = torch.autograd.grad(s, [Xd, Yd] + want, allow_unused=True)
    dX, dY, *dw = [torch.zeros_like(t) if d is None else d
                   for t, d in zip([Xd, Yd] + want, grads)]
    dw = iter(dw)
    dh = tuple(next(dw) if h.requires_grad else torch.zeros_like(h)
               for h in hyper)
    return v.detach(), dX, dY, dh


class _GramLincomb(torch.autograd.Function):
    """``S = sum_ij W_ij k(X_i, Y_j)`` with eager gradients: each chunk's
    forward and adjoint run inside the forward's loop, and only ``gX, gY,
    g_hyper`` and the Gram values (for ``dW``) are kept; the backward scales
    them by ``g`` (JAX ``_gram_lincomb_fwd``/``_bwd``)."""

    @staticmethod
    def forward(ctx, static_kernel, cfg, sym, X, Y, W, *hyper):
        dyadic_order, naive, solver, grad_solver, chunk = cfg
        route = routes.resolve(static_kernel, X.device.type, solver, X.dtype,
                               grad_solver, _refined(X, Y, dyadic_order),
                               need_grad=True)
        sv = _launch_sigma(static_kernel) if route.family == "gen" else None
        ii, jj, w = _lincomb_pairs(X.shape[0], Y.shape[0], W, sym)
        acc_dtype = torch.promote_types(W.dtype, X.dtype)
        w = w.to(acc_dtype)
        S = torch.zeros((), dtype=acc_dtype, device=X.device)
        gX, gY = torch.zeros_like(X), torch.zeros_like(Y)
        gh = [torch.zeros_like(h) for h in hyper]
        vals = []
        for s in range(0, ii.shape[0], chunk):
            with span("sk.est.chunk"):
                ic, jc, wc = ii[s:s + chunk], jj[s:s + chunk], w[s:s + chunk]
                if route.family == "gen":
                    v, dX, dY, dh = _chunk_grads_gen(static_kernel, X, Y, ic,
                                                     jc, wc, route, cfg, sv)
                else:
                    v, dX, dY, dh = _chunk_grads_autograd(
                        static_kernel, X, Y, ic, jc, wc, hyper, cfg)
                S = S + torch.sum(wc * v.to(acc_dtype))
                gX += dX.to(X.dtype)
                gY += dY.to(Y.dtype)
                for acc, d in zip(gh, dh):
                    acc += d.to(acc)
                vals.append(v)
        v = torch.cat([X.new_empty(0)] + vals).to(W.dtype)
        if sym:
            K = W.new_zeros(W.shape)
            K[ii, jj] = v
            K = K + K.T - torch.diag(torch.diag(K))
        else:
            K = v.reshape(W.shape)
        ctx.save_for_backward(gX, gY, K, *gh)
        return S

    @staticmethod
    def backward(ctx, g):
        gX, gY, K, *gh = ctx.saved_tensors
        return (None, None, None, (g * gX).to(gX.dtype),
                (g * gY).to(gY.dtype), (g * K).to(K.dtype),
                *[(g * h).to(h.dtype) for h in gh])


@spanned("sk.est.sig_gram_lincomb")
def sig_gram_lincomb(static_kernel, X, Y, W, dyadic_order=0, sym=False,
                     naive=False, solver="auto",
                     length_bucket: Optional[int] = None, grad_solver="auto",
                     pair_chunk: int = 128):
    """Scalar ``sum_ij W_ij k_sig(X_i, Y_j)``, solved ``pair_chunk`` pairs at
    a time so the Gram never materialises. ``sym=True`` (``X is Y``) solves
    only the ``A(A+1)/2`` triangle. Differentiable in ``X``, ``Y``, ``W`` and
    the kernel's hyper-parameter, with memory bounded by one chunk: the
    gradients are computed chunk by chunk in the forward when any of them
    requires a gradient."""
    X, Y = _prepare(static_kernel, X, Y, length_bucket, grad_solver)
    if sym and X.shape != Y.shape:
        raise ValueError("sym=True requires X and Y of identical shape "
                         "(the caller asserts Y is X)")
    chunk = int(pair_chunk)
    if chunk < 1:
        raise ValueError(f"pair_chunk must be >= 1; got {pair_chunk}")
    cfg = (dyadic_order, naive, solver, grad_solver, chunk)
    hyper = _hyper(static_kernel)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (X, Y, W) + hyper):
        return _GramLincomb.apply(static_kernel, cfg, sym, X, Y, W, *hyper)
    ii, jj, w = _lincomb_pairs(X.shape[0], Y.shape[0], W, sym)
    return _lincomb_value(static_kernel, X, Y, ii, jj, w, cfg)


@spanned("sk.est.tile")
def _derivatives_tile(static_kernel, X, Y, gamma, dyadic_order, eps,
                      route):
    """``(K, K_diff, K_diffdiff)`` of one ``(bx, by)`` tile: the Gram and
    its first and second directional derivatives along ``gamma`` (a nested
    ``torch.func.jvp``, or finite differences of step ``eps``), their
    increment grids, and the triple sweep (K5 on the ``"cuda"`` route)."""
    def gram(x):
        return static_kernel.Gram_matrix(x, Y)

    with span("sk.grid"):
        if eps is None:
            def first(x):
                return torch.func.jvp(gram, (x,), (gamma,))

            (G, dG), (_, ddG) = torch.func.jvp(first, (X,), (gamma,))
        else:
            G = gram(X)
            G1 = gram(X + eps * gamma)
            G2 = gram(X + 2.0 * eps * gamma)
            dG = (G1 - G) / eps
            ddG = (G - 2.0 * G1 + G2) / (eps * eps)
        grids = [double_difference(t) for t in (G, dG, ddG)]
        del G, dG, ddG
    if route == "cuda":
        a, b = grids[0].shape[:2]
        flat = [t.reshape((a * b,) + t.shape[2:]).contiguous()
                for t in grids]
        del grids
        return tuple(t.reshape(a, b) for t in cuda_deriv.deriv_solve_final(
            *flat, dyadic_order))
    return scan_solver.solve_derivatives_final(
        *(dyadic_refine(t, dyadic_order) for t in grids))


@spanned("sk.est.sig_kernel_and_derivatives_gram")
def sig_kernel_and_derivatives_gram(static_kernel, X, Y, gamma,
                                    dyadic_order=0,
                                    eps: Optional[float] = None,
                                    solver="auto",
                                    max_batch: Optional[int] = None):
    """Kernel + first/second directional derivatives along ``gamma``.

    With ``eps=None`` (default) the static kernel's directional derivatives
    are exact (nested ``torch.func.jvp``); a float ``eps`` gives the finite-
    difference parity mode. Returns three ``(bx, by)`` tensors ``(K,
    K_diff, K_diffdiff)`` in the input dtype. ``max_batch`` tiles the
    ``(bx, by)`` pair grid, ``max_batch**2`` pairs (three grids each) at a
    time. The route (:func:`.ops.routes.resolve_derivatives`): K5 for CUDA
    tensors at any length, forward only (an input that requires a gradient
    raises there); the plain sweep on the CPU or with ``solver="scan"``,
    differentiable by autograd.
    """
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (X, Y, gamma) + _hyper(static_kernel))
    f = 2 ** dyadic_order
    shape = ((X.shape[1] - 1) * f, (Y.shape[1] - 1) * f)
    route = routes.resolve_derivatives(X.device.type, solver, needs_grad,
                                       shape, X.dtype.itemsize)
    bx, by = X.shape[0], Y.shape[0]
    mb = max(bx, by, 1) if max_batch is None else max_batch
    tiles = [[_derivatives_tile(static_kernel, X[a:a + mb], Y[b:b + mb],
                                gamma[a:a + mb], dyadic_order, eps, route)
              for b in range(0, by, mb)] for a in range(0, bx, mb)]
    return tuple(torch.cat([torch.cat([t[k] for t in row], dim=1)
                            for row in tiles], dim=0) for k in range(3))


def k_kgrad(X, Y, gamma, dyadic_order, static_kernel, eps=1e-4):
    """The reference's argument order and finite-difference default for
    :func:`sig_kernel_and_derivatives_gram` (pass ``eps=None`` for the exact
    jvp mode)."""
    return sig_kernel_and_derivatives_gram(
        static_kernel, X, Y, gamma, dyadic_order=dyadic_order, eps=eps)


def _offdiag_mean(K):
    n = K.shape[0]
    return (torch.sum(K) - torch.sum(torch.diag(K))) / (n * (n - 1.0))


def _offdiag_w(n, dtype, device):
    """Weights of the unbiased off-diagonal mean as a lincomb matrix."""
    return (1.0 - torch.eye(n, dtype=dtype, device=device)) / (n * (n - 1.0))


@spanned("sk.est.sig_distance")
def sig_distance(static_kernel, X, Y, dyadic_order=0, naive=False,
                 solver="auto", max_batch: Optional[int] = 100,
                 grad_solver="auto"):
    """``mean k(X,X) + mean k(Y,Y) - 2 mean k(X,Y)`` over paired batches."""
    kw = dict(dyadic_order=dyadic_order, naive=naive, solver=solver,
              max_batch=max_batch, grad_solver=grad_solver)
    k_xx = sig_kernel(static_kernel, X, X, **kw)
    k_yy = sig_kernel(static_kernel, Y, Y, **kw)
    k_xy = sig_kernel(static_kernel, X, Y, **kw)
    return torch.mean(k_xx) + torch.mean(k_yy) - 2.0 * torch.mean(k_xy)


def _scoring_core(static_kernel, X, Y2, dyadic_order, naive, solver,
                  max_batch, grad_solver, pair_chunk):
    """``offdiag_mean(K_XX) - 2 mean(K_XY2)``, the body of both scoring
    rules; the bounded-memory lincomb route when a batch exceeds
    ``max_batch``."""
    n, m = X.shape[0], Y2.shape[0]
    if max_batch is not None and (n > max_batch or m > max_batch):
        kw = dict(dyadic_order=dyadic_order, naive=naive, solver=solver,
                  grad_solver=grad_solver, pair_chunk=pair_chunk)
        dt, dev = X.dtype, X.device
        s_xx = sig_gram_lincomb(static_kernel, X, X, _offdiag_w(n, dt, dev),
                                sym=True, **kw)
        w_xy = torch.full((n, m), -2.0 / (n * m), dtype=dt, device=dev)
        return s_xx + sig_gram_lincomb(static_kernel, X, Y2, w_xy, **kw)
    kw = dict(dyadic_order=dyadic_order, naive=naive, solver=solver,
              max_batch=max_batch, grad_solver=grad_solver)
    K_XX = sig_gram(static_kernel, X, X, sym=True, **kw)
    K_XY = sig_gram(static_kernel, X, Y2, sym=False, **kw)
    return _offdiag_mean(K_XX) - 2.0 * torch.mean(K_XY)


@spanned("sk.est.sig_scoring_rule")
def sig_scoring_rule(static_kernel, X, y, dyadic_order=0, naive=False,
                     solver="auto", max_batch: Optional[int] = 100,
                     grad_solver="auto", pair_chunk: int = 128):
    """Scoring rule ``E[k(X,X)] - 2 E[k(X,y)]`` with unbiased diagonal
    removal."""
    return _scoring_core(static_kernel, X, y, dyadic_order, naive, solver,
                         max_batch, grad_solver, pair_chunk)


@spanned("sk.est.sig_expected_scoring_rule")
def sig_expected_scoring_rule(static_kernel, X, Y, dyadic_order=0,
                              naive=False, solver="auto",
                              max_batch: Optional[int] = 100,
                              grad_solver="auto", pair_chunk: int = 128):
    """Expected scoring rule ``E_Y[S(X, y)]``."""
    return _scoring_core(static_kernel, X, Y, dyadic_order, naive, solver,
                         max_batch, grad_solver, pair_chunk)


@spanned("sk.est.sig_mmd")
def sig_mmd(static_kernel, X, Y, dyadic_order=0, naive=False,
            solver="auto", max_batch: Optional[int] = 100,
            grad_solver="auto", pair_chunk: int = 128):
    """Unbiased signature-kernel MMD^2 between samples ``X`` and ``Y``.

    When either batch exceeds ``max_batch`` the three Gram terms run through
    :func:`sig_gram_lincomb` (the two symmetric ones on their triangles).
    """
    n, m = X.shape[0], Y.shape[0]
    if max_batch is not None and (n > max_batch or m > max_batch):
        kw = dict(dyadic_order=dyadic_order, naive=naive, solver=solver,
                  grad_solver=grad_solver, pair_chunk=pair_chunk)
        dt, dev = X.dtype, X.device
        s_xx = sig_gram_lincomb(static_kernel, X, X, _offdiag_w(n, dt, dev),
                                sym=True, **kw)
        s_yy = sig_gram_lincomb(static_kernel, Y, Y, _offdiag_w(m, dt, dev),
                                sym=True, **kw)
        w_xy = torch.full((n, m), -2.0 / (n * m), dtype=dt, device=dev)
        s_xy = sig_gram_lincomb(static_kernel, X, Y, w_xy, **kw)
        return s_xx + s_yy + s_xy
    kw = dict(dyadic_order=dyadic_order, naive=naive, solver=solver,
              max_batch=max_batch, grad_solver=grad_solver)
    K_XX = sig_gram(static_kernel, X, X, sym=True, **kw)
    K_YY = sig_gram(static_kernel, Y, Y, sym=True, **kw)
    K_XY = sig_gram(static_kernel, X, Y, sym=False, **kw)
    return _offdiag_mean(K_XX) + _offdiag_mean(K_YY) - 2.0 * torch.mean(K_XY)


class SigKernel(nn.Module):
    """Signature kernel ``k_sig(x, y) = <S(f(x)), S(f(y))>``.

    Holds the static kernel (a submodule, so ``.to(device)`` moves its
    hyper-parameters), the dyadic refinement order and the solver scheme.
    """

    def __init__(self, static_kernel, dyadic_order, _naive_solver=False,
                 solver="auto", grad_solver="auto"):
        super().__init__()
        self.static_kernel = static_kernel
        self.dyadic_order = dyadic_order
        self._naive_solver = _naive_solver
        self.solver = solver
        self.grad_solver = grad_solver

    def _kw(self, max_batch):
        return dict(dyadic_order=self.dyadic_order, naive=self._naive_solver,
                    solver=self.solver, max_batch=max_batch,
                    grad_solver=self.grad_solver)

    def compute_kernel(self, X, Y, max_batch=100):
        return sig_kernel(self.static_kernel, X, Y, **self._kw(max_batch))

    def compute_Gram(self, X, Y, sym=False, max_batch=100):
        return sig_gram(self.static_kernel, X, Y, sym=sym,
                        **self._kw(max_batch))

    def compute_kernel_and_derivatives_Gram(self, X, Y, gamma, max_batch=100,
                                            eps=None):
        return sig_kernel_and_derivatives_gram(
            self.static_kernel, X, Y, gamma, dyadic_order=self.dyadic_order,
            eps=eps, solver=self.solver, max_batch=max_batch)

    def compute_distance(self, X, Y, max_batch=100):
        return sig_distance(self.static_kernel, X, Y, **self._kw(max_batch))

    def compute_scoring_rule(self, X, y, max_batch=100):
        return sig_scoring_rule(self.static_kernel, X, y,
                                **self._kw(max_batch))

    def compute_expected_scoring_rule(self, X, Y, max_batch=100):
        return sig_expected_scoring_rule(self.static_kernel, X, Y,
                                         **self._kw(max_batch))

    def compute_mmd(self, X, Y, max_batch=100):
        return sig_mmd(self.static_kernel, X, Y, **self._kw(max_batch))
