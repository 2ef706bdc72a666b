"""The derivative Gram against the JAX package on the same numpy inputs: the
plain triple sweep ``scan_solver.solve_derivatives_final`` and K5's plain
version ``deriv_solve_final_plain`` against JAX's scan tier, the estimator
``sig_kernel_and_derivatives_gram`` / ``k_kgrad`` /
``SigKernel.compute_kernel_and_derivatives_Gram`` (both ``eps`` modes,
tiled and untiled, RBF, Linear and a functional-data kernel), its gradient
on the plain route, the length-1 case, and the CUDA route's refusal of
inputs that require a gradient (the resolver's whole matrix is in
``test_torch_routes.py``).

Bars: float64 K within 1e-10 relative, K_diff / K_diffdiff and gradients
within 1e-9 of max |ref|; float32 inputs within 1e-4 (K) and 1e-3 (the
derivatives) of max |ref| of JAX in float64. One exception, set by the
finite-difference scheme's conditioning: with ``eps=1e-4`` the second
difference ``(G - 2 G1 + G2) / eps^2`` divides the two packages' last-bit
differences in the Gram (their einsums sum in other orders, ~1e-16) by
1e-8, so K_diffdiff is held at 1e-6 of max |ref| in that mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigkernel_tpu as sk
from sigkernel_tpu.ops import scan_solver as jscan
from sigkernel_tpu.utils import dyadic_refine as jrefine

import sigkernel_tpu_torch as skt
from sigkernel_tpu_torch.ops import cuda_deriv, routes, scan_solver

BARS = {np.float64: (1e-10, 1e-9), np.float32: (1e-4, 1e-3)}


FD_DD_BAR = 1e-6  # K_diffdiff, eps=1e-4, float64 (see above)


def _check(got, want, dtype, dd_bar=None):
    """float64 K entry-wise relative; float32 K and every derivative
    against max |ref|."""
    k_bar, d_bar = BARS[dtype]
    got = [np.asarray(g.detach().double()) for g in got]
    want = [np.asarray(w) for w in want]
    for g, w in zip(got, want):
        assert g.shape == w.shape
    if dtype == np.float64:
        assert np.max(np.abs(got[0] - want[0]) / np.abs(want[0])) <= k_bar
    else:
        assert np.abs(got[0] - want[0]).max() <= k_bar * np.abs(want[0]).max()
    for g, w, bar in zip(got[1:], want[1:], (d_bar, dd_bar or d_bar)):
        assert np.abs(g - w).max() <= bar * max(np.abs(w).max(), 1e-300)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("dyadic", [0, 1, 2])
@pytest.mark.parametrize("Mb,Nb", [(5, 9), (9, 5)])
def test_triple_sweep_and_plain_version_match_jax(rng, dtype, dyadic, Mb, Nb):
    grids = [rng.normal(size=(3, Mb, Nb)) * 0.4 for _ in range(3)]
    want = jscan.solve_derivatives_final(
        *(jrefine(jnp.asarray(g), dyadic) for g in grids))
    tg = [torch.tensor(g.astype(dtype)) for g in grids]
    _check(scan_solver.solve_derivatives_final(
        *(skt.utils.dyadic_refine(g, dyadic) for g in tg)), want, dtype)
    before = cuda_deriv.COUNTS["plain"]
    got = cuda_deriv.deriv_solve_final(*tg, dyadic)  # CPU: the plain version
    assert cuda_deriv.COUNTS["plain"] == before + 1
    assert all(g.dtype == tg[0].dtype and g.shape == (3,) for g in got)
    _check(got, want, dtype)


def _kernels(kind):
    """(JAX kernel, port kernel, path rank)."""
    if kind == "rbf":
        return sk.RBFKernel(0.6), skt.RBFKernel(0.6), 3
    if kind == "linear":
        return sk.LinearKernel(0.8), skt.LinearKernel(0.8), 3
    return sk.RBF_SQR_Kernel(0.9, 1.3), skt.RBF_SQR_Kernel(0.9, 1.3), 4


def _inputs(rng, rank, M=7, N=5):
    """X (5, M, ...), Y (4, N, ...), gamma like X, as numpy."""
    if rank == 3:
        shape = lambda b, L: (b, L, 2)
    else:
        shape = lambda b, L: (b, L, 3, 2)

    def paths(b, L):
        steps = rng.normal(size=shape(b, L)) * 0.5 / np.sqrt(L)
        return np.cumsum(steps, axis=1)

    return paths(5, M), paths(4, N), paths(5, M)


@pytest.mark.parametrize("eps", [None, 1e-4])
@pytest.mark.parametrize("kind,dyadic", [("rbf", 1), ("linear", 0),
                                         ("sqr", 2)])
def test_estimator_matches_jax(rng, kind, dyadic, eps):
    jk, tk, rank = _kernels(kind)
    X, Y, G = _inputs(rng, rank)
    want = sk.sig_kernel_and_derivatives_gram(
        jk, jnp.asarray(X), jnp.asarray(Y), jnp.asarray(G),
        dyadic_order=dyadic, eps=eps)
    sig = skt.SigKernel(tk, dyadic_order=dyadic)
    tX, tY, tG = (torch.tensor(a) for a in (X, Y, G))
    full = sig.compute_kernel_and_derivatives_Gram(tX, tY, tG, eps=eps,
                                                   max_batch=None)
    dd_bar = None if eps is None else FD_DD_BAR
    _check(full, want, np.float64, dd_bar)
    # the tiles' einsums block differently: tiled to untiled at the same bars
    tiled = sig.compute_kernel_and_derivatives_Gram(tX, tY, tG, eps=eps,
                                                    max_batch=2)
    _check(tiled, [t.numpy() for t in full], np.float64, dd_bar)
    # float32 inputs against JAX in float64
    f32 = sig.compute_kernel_and_derivatives_Gram(
        *(t.float() for t in (tX, tY, tG)), eps=eps)
    assert all(t.dtype == torch.float32 for t in f32)
    if eps is None:  # finite differences in float32 measure their own error
        _check(f32, want, np.float32)


def test_k_kgrad_keeps_the_reference_order(rng):
    X, Y, G = _inputs(rng, 3, M=6, N=8)
    want = sk.k_kgrad(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(G), 1,
                      sk.RBFKernel(0.5))
    got = skt.k_kgrad(*(torch.tensor(a) for a in (X, Y, G)), 1,
                      skt.RBFKernel(0.5))
    _check(got, want, np.float64, FD_DD_BAR)


def test_length_one_path(rng):
    X, Y, G = _inputs(rng, 3, M=1, N=6)
    got = skt.sig_kernel_and_derivatives_gram(
        skt.RBFKernel(0.5), *(torch.tensor(a) for a in (X, Y, G)),
        dyadic_order=1)
    want = sk.sig_kernel_and_derivatives_gram(
        sk.RBFKernel(0.5), *(jnp.asarray(a) for a in (X, Y, G)),
        dyadic_order=1)
    for g, w, value in zip(got, want, (1.0, 0.0, 0.0)):
        assert torch.equal(g, torch.full((5, 4), value, dtype=g.dtype))
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_plain_route_gradient_matches_jax(rng):
    """The plain sweep is differentiable by autograd, as JAX's scan is: the
    gradient of K + K_diff + K_diffdiff in X, gamma and sigma."""
    X, Y, G = _inputs(rng, 3, M=6, N=5)

    def jloss(x, g, s):
        out = sk.sig_kernel_and_derivatives_gram(
            sk.RBFKernel(s), x, jnp.asarray(Y), g, dyadic_order=1)
        return sum(jnp.sum(t) for t in out)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(X), jnp.asarray(G),
                                              jnp.asarray(0.7))
    x, g = torch.tensor(X, requires_grad=True), torch.tensor(G,
                                                             requires_grad=True)
    s = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    out = skt.sig_kernel_and_derivatives_gram(skt.RBFKernel(s), x,
                                              torch.tensor(Y), g,
                                              dyadic_order=1)
    sum(t.sum() for t in out).backward()
    for t, w in zip((x, g, s), want):
        w = np.asarray(w)
        err = np.abs(t.grad.numpy() - w).max()
        assert err <= 1e-9 * np.abs(w).max()


def test_cuda_route_refuses_inputs_that_need_a_gradient(rng, monkeypatch):
    """The estimator asks the resolver for the CUDA route (as on CUDA
    tensors): without gradients it takes K5's wrapper (here its plain
    version, the tensors being on the CPU); an input or hyper-parameter that
    requires a gradient raises, unless gradients are off."""
    resolve = routes.resolve_derivatives
    monkeypatch.setattr(routes, "resolve_derivatives",
                        lambda dev, solver, grad, shape, itemsize: resolve(
                            "cuda", solver, grad, shape, itemsize))
    X, Y, G = (torch.tensor(a) for a in _inputs(rng, 3))
    before = cuda_deriv.COUNTS["plain"]
    got = skt.sig_kernel_and_derivatives_gram(skt.RBFKernel(0.6), X, Y, G,
                                              dyadic_order=1, max_batch=3)
    assert cuda_deriv.COUNTS["plain"] == before + 4  # one call per tile
    want = skt.sig_kernel_and_derivatives_gram(skt.RBFKernel(0.6), X, Y, G,
                                               dyadic_order=1, solver="scan")
    _check(got, [t.numpy() for t in want], np.float64)
    sigma = torch.tensor(0.6, dtype=torch.float64, requires_grad=True)
    leaf = lambda t: t.clone().requires_grad_()  # noqa: E731
    for k, args in ((skt.RBFKernel(0.6), (leaf(X), Y, G)),
                    (skt.RBFKernel(0.6), (X, Y, leaf(G))),
                    (skt.RBFKernel(sigma), (X, Y, G))):
        with pytest.raises(ValueError, match="forward only"):
            skt.sig_kernel_and_derivatives_gram(k, *args, dyadic_order=1)
        with torch.no_grad():
            skt.sig_kernel_and_derivatives_gram(k, *args, dyadic_order=1)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("dyadic", [0, 2])
def test_estimator_passes_the_refined_shape_and_itemsize(rng, monkeypatch,
                                                         dtype, dyadic):
    """``sig_kernel_and_derivatives_gram`` asks the resolver with the
    refined shape ``((Lx - 1) 2^d, (Ly - 1) 2^d)`` and the inputs'
    itemsize; routed as if on CUDA, it takes K5's wrapper (here its plain
    version, the tensors being on the CPU) at every shape, equal to
    ``solver="scan"``; with a gradient it raises (K5 is forward only) under
    "auto" and "cuda" alike."""
    seen = []
    resolve = routes.resolve_derivatives

    def spy(dev, solver, grad, shape, itemsize):
        seen.append((shape, itemsize))
        return resolve("cuda", solver, grad, shape, itemsize)

    monkeypatch.setattr(routes, "resolve_derivatives", spy)
    X, Y, G = (torch.tensor(a, dtype=dtype) for a in _inputs(rng, 3))
    X = X[:, :5]
    G = G[:, :5]
    before = cuda_deriv.COUNTS["plain"]
    got = skt.sig_kernel_and_derivatives_gram(skt.RBFKernel(0.6), X, Y, G,
                                              dyadic_order=dyadic)
    f = 2 ** dyadic
    assert seen == [((4 * f, (Y.shape[1] - 1) * f), dtype.itemsize)]
    assert cuda_deriv.COUNTS["plain"] == before + 1  # K5's wrapper, one tile
    for solver in ("auto", "cuda"):
        with pytest.raises(ValueError, match="forward only"):
            skt.sig_kernel_and_derivatives_gram(
                skt.RBFKernel(0.6), X.clone().requires_grad_(), Y, G,
                dyadic_order=dyadic, solver=solver)
    monkeypatch.undo()
    want = skt.sig_kernel_and_derivatives_gram(skt.RBFKernel(0.6), X, Y, G,
                                               dyadic_order=dyadic,
                                               solver="scan")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
