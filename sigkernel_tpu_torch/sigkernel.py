"""Signature-kernel estimators: the public API of the port (forward values).

Counterpart of :mod:`sigkernel_tpu.sigkernel` with the same signatures:
``sig_kernel``, ``sig_gram`` (with the ``sym`` triangle), ``sig_gram_lincomb``,
``sig_mmd``, ``sig_distance`` and the ``SigKernel`` module. Each tile's solver
family comes from :func:`.ops.routes.resolve_family`:

- ``gen``: RBF increments generated in the K1 kernel from the paths and the
  pair index arrays (no path copies per pair, no increment grid);
- ``inc``/``scan``: ``double_difference`` of the static-kernel Gram in torch,
  solved by the K2 kernel or the plain loop (:func:`.ops.solve.solve`).

Forward only: gradients (the adjoint PDE) are not ported yet, so a call that
would need them raises ``NotImplementedError`` rather than differentiate
through the plain loop (which would give gradients on the CPU and none on the
card).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .ops import cuda_gen, routes
from .ops.solve import solve
from .utils import double_difference, pad_length

_GRAD_SOLVERS = ("auto", "f32", "df64")


def _check_grad_solver(grad_solver):
    if grad_solver not in _GRAD_SOLVERS:
        raise ValueError(f"unknown grad_solver {grad_solver!r}; expected one "
                         f"of {_GRAD_SOLVERS}")


def _forward_only(static_kernel, *tensors):
    """Refuse inputs that ask for gradients while grad mode is on."""
    if not torch.is_grad_enabled():
        return
    if (any(t.requires_grad for t in tensors)
            or any(t.requires_grad for t in static_kernel.buffers())
            or any(t.requires_grad for t in static_kernel.parameters())):
        raise NotImplementedError(
            "gradients of the signature kernel (the adjoint PDE) are not "
            "ported yet: they land in the next slice (see ROADMAP.md). Call "
            "under torch.no_grad() or detach the inputs.")


def _prepare(static_kernel, X, Y, length_bucket, grad_solver, *more):
    _check_grad_solver(grad_solver)
    _forward_only(static_kernel, X, Y, *more)
    if length_bucket:
        X = pad_length(X, length_bucket)
        Y = pad_length(Y, length_bucket)
    return X.contiguous(), Y.contiguous()


def _pairs(static_kernel, X, Y, ii, jj, dyadic_order, naive, solver):
    """``k_sig(X[ii[p]], Y[jj[p]])`` per pair; ``ii = jj = None`` pairs
    ``X[p]`` with ``Y[p]``."""
    fam = routes.resolve_family(static_kernel, X.device.type, solver)
    if fam == "gen":
        if ii is None:
            ii = jj = torch.arange(X.shape[0], device=X.device)
        return cuda_gen.rbf_gen_solve_final(X, Y, ii, jj, static_kernel.sigma,
                                            dyadic_order, naive)
    x = X if ii is None else X[ii]
    y = Y if jj is None else Y[jj]
    dd = double_difference(static_kernel.batch_kernel(x, y))
    return solve(dd, naive, solver, dyadic_order)


def _gram_tile(static_kernel, x, y, dyadic_order, naive, solver):
    """One ``(a, b)`` Gram tile."""
    a, b = x.shape[0], y.shape[0]
    if routes.resolve_family(static_kernel, x.device.type, solver) == "gen":
        ii = torch.arange(a, device=x.device).repeat_interleave(b)
        jj = torch.arange(b, device=x.device).repeat(a)
        return cuda_gen.rbf_gen_solve_final(
            x, y, ii, jj, static_kernel.sigma, dyadic_order,
            naive).reshape(a, b)
    dd = double_difference(static_kernel.Gram_matrix(x, y))
    return solve(dd, naive, solver, dyadic_order)


def sig_kernel(static_kernel, X, Y, dyadic_order=0, naive=False,
               solver="auto", max_batch: Optional[int] = 100,
               length_bucket: Optional[int] = None, grad_solver="auto"):
    """Pairwise signature kernel ``k_sig(X^i, Y^i)`` -> shape ``(batch,)``,
    solved ``max_batch`` pairs at a time."""
    X, Y = _prepare(static_kernel, X, Y, length_bucket, grad_solver)
    batch = X.shape[0]
    if max_batch is None or batch <= max_batch:
        return _pairs(static_kernel, X, Y, None, None, dyadic_order, naive,
                      solver)
    return torch.cat([
        _pairs(static_kernel, X[s:s + max_batch], Y[s:s + max_batch], None,
               None, dyadic_order, naive, solver)
        for s in range(0, batch, max_batch)])


def _gram_sym_triangle(static_kernel, X, dyadic_order, naive, solver,
                       max_batch):
    """Symmetric Gram ``G(X, X)``: solve exactly the ``A(A+1)/2`` upper
    triangle (the solve is transpose-covariant), ``max_batch**2`` pairs at a
    time, then mirror."""
    A = X.shape[0]
    iu, ju = torch.triu_indices(A, A, device=X.device)
    P = iu.shape[0]
    chunk = P if max_batch is None else min(max(max_batch, 1) ** 2, P)
    vals = torch.cat([X.new_empty(0)] + [
        _pairs(static_kernel, X, X, iu[s:s + chunk], ju[s:s + chunk],
               dyadic_order, naive, solver)
        for s in range(0, P, chunk)])
    K = X.new_zeros(A, A)
    K[iu, ju] = vals
    return K + K.T - torch.diag(torch.diag(K))


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
                                  solver, max_batch)
    bx, by = X.shape[0], Y.shape[0]
    mb = max(bx, by, 1) if max_batch is None else max_batch
    K = torch.cat([
        torch.cat([_gram_tile(static_kernel, X[a:a + mb], Y[b:b + mb],
                              dyadic_order, naive, solver)
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


def sig_gram_lincomb(static_kernel, X, Y, W, dyadic_order=0, sym=False,
                     naive=False, solver="auto",
                     length_bucket: Optional[int] = None, grad_solver="auto",
                     pair_chunk: int = 128):
    """Scalar ``sum_ij W_ij k_sig(X_i, Y_j)``, solved ``pair_chunk`` pairs at
    a time so the Gram never materialises. ``sym=True`` (``X is Y``) solves
    only the ``A(A+1)/2`` triangle."""
    X, Y = _prepare(static_kernel, X, Y, length_bucket, grad_solver, W)
    if sym and X.shape != Y.shape:
        raise ValueError("sym=True requires X and Y of identical shape "
                         "(the caller asserts Y is X)")
    chunk = int(pair_chunk)
    if chunk < 1:
        raise ValueError(f"pair_chunk must be >= 1; got {pair_chunk}")
    ii, jj, w = _lincomb_pairs(X.shape[0], Y.shape[0], W, sym)
    acc_dtype = torch.promote_types(W.dtype, X.dtype)
    S = torch.zeros((), dtype=acc_dtype, device=X.device)
    for s in range(0, ii.shape[0], chunk):
        v = _pairs(static_kernel, X, Y, ii[s:s + chunk], jj[s:s + chunk],
                   dyadic_order, naive, solver)
        S = S + torch.sum(w[s:s + chunk] * v.to(acc_dtype))
    return S


def _offdiag_mean(K):
    n = K.shape[0]
    return (torch.sum(K) - torch.sum(torch.diag(K))) / (n * (n - 1.0))


def _offdiag_w(n, dtype, device):
    """Weights of the unbiased off-diagonal mean as a lincomb matrix."""
    return (1.0 - torch.eye(n, dtype=dtype, device=device)) / (n * (n - 1.0))


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

    def compute_distance(self, X, Y, max_batch=100):
        return sig_distance(self.static_kernel, X, Y, **self._kw(max_batch))

    def compute_mmd(self, X, Y, max_batch=100):
        return sig_mmd(self.static_kernel, X, Y, **self._kw(max_batch))
