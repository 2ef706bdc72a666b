"""Gradients of the port's estimators against ``jax.grad`` of the same JAX
calls on the same numpy inputs: kernel, Gram (with the ``sym`` triangle) and
the Gram linear combination here; MMD, distance, the scoring rules and the
``SigKernel`` methods in ``test_torch_grad_mmd.py`` (which shares the
helpers below).

Gradients are taken in ``X``, ``Y``, ``W`` and the static kernel's
hyper-parameter (``RBFKernel.sigma``, ``LinearKernel.scale``), with RBF and
Linear kernels, dyadic orders 0/1/2 and both schemes. On the CPU both
packages run their plain tiers: the JAX scan tier's ``custom_vjp`` grid-route
backward, and the port's plain adjoint (:func:`ops.solve.grid_route_bwd`).

Bars, as max |err| over max |grad| of each gradient: float64 within 1e-9
(about 1e-13 is seen); float32 inputs against JAX float64 within 1e-3. The
float32 errors come from the float32 sweeps and the cancellation of the
double difference's transpose; they are mostly about 1e-5, up to 1.6e-4 for
a hyper-parameter gradient that sums pair gradients of mixed sign.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigkernel_tpu as sk

import sigkernel_tpu_torch as skt

from conftest import make_paths

BARS = {torch.float64: 1e-9, torch.float32: 1e-3}
HYPER = {"RBFKernel": 0.5, "LinearKernel": 0.8}
# every kernel at every dyadic order, the two schemes alternating
CONFIGS = [("RBFKernel", 0, False), ("RBFKernel", 1, True),
           ("RBFKernel", 2, False), ("LinearKernel", 0, True),
           ("LinearKernel", 1, False), ("LinearKernel", 2, True)]


def inputs(rng, D=2):
    """X (4, 7, D), Y (5, 11, D): unequal lengths, batches that the chunk
    sizes below do not divide; Y4 (4, 11, D) pairs with X."""
    X = make_paths(rng, 4, 7, D, scale=0.6)
    Y = make_paths(rng, 5, 11, D, scale=0.6)
    return X, Y, Y[:4]


def check_grads(kind, jax_fn, torch_fn, arrays, bars=BARS):
    """``jax_fn(kernel, *arrays)`` and ``torch_fn(kernel, *tensors)`` are
    scalars; their gradients in every array and in the kernel's
    hyper-parameter must agree within ``bars``."""
    h = HYPER[kind]

    def jloss(arrs, hh):
        return jax_fn(getattr(sk, kind)(hh), *arrs)

    want_a, want_h = jax.grad(jloss, argnums=(0, 1))(
        tuple(jnp.asarray(a) for a in arrays), jnp.asarray(h))
    want = [np.asarray(w) for w in want_a] + [np.asarray(want_h)]
    assert any(np.abs(w).max() > 0 for w in want)
    for dtype, bar in bars.items():
        ts = [torch.tensor(a, dtype=dtype, requires_grad=True)
              for a in arrays]
        th = torch.tensor(h, dtype=dtype, requires_grad=True)
        out = torch_fn(getattr(skt, kind)(th), *ts)
        assert out.dim() == 0
        out.backward()
        for t, w in zip(ts + [th], want):
            assert t.grad is not None and t.grad.dtype == dtype
            got = t.grad.double().numpy()
            assert got.shape == w.shape
            scale = max(np.abs(w).max(), 1e-300)
            assert np.abs(got - w).max() <= bar * scale, (dtype, t.shape)


def _weights(rng, *shape):
    return rng.normal(size=shape)


@pytest.mark.parametrize("kind,dyadic,naive", CONFIGS)
def test_sig_kernel_grad(rng, kind, dyadic, naive):
    X, _, Y4 = inputs(rng)
    R = _weights(rng, 4)
    kw = dict(dyadic_order=dyadic, naive=naive, max_batch=3)
    check_grads(
        kind,
        lambda k, x, y: jnp.sum(R * sk.sig_kernel(k, x, y, **kw)),
        lambda k, x, y: torch.sum(torch.tensor(R, dtype=x.dtype)
                                  * skt.sig_kernel(k, x, y, **kw)),
        [X, Y4])


@pytest.mark.parametrize("kind,dyadic,naive", CONFIGS)
def test_sig_gram_grad(rng, kind, dyadic, naive):
    X, Y, _ = inputs(rng)
    R = _weights(rng, 4, 5)
    kw = dict(dyadic_order=dyadic, naive=naive, max_batch=3)
    check_grads(
        kind,
        lambda k, x, y: jnp.sum(R * sk.sig_gram(k, x, y, **kw)),
        lambda k, x, y: torch.sum(torch.tensor(R, dtype=x.dtype)
                                  * skt.sig_gram(k, x, y, **kw)),
        [X, Y])


@pytest.mark.parametrize("kind,dyadic,naive", CONFIGS)
def test_sig_gram_sym_grad(rng, kind, dyadic, naive):
    X, _, _ = inputs(rng)
    R = _weights(rng, 4, 4)
    kw = dict(dyadic_order=dyadic, naive=naive, max_batch=2, sym=True)
    check_grads(
        kind,
        lambda k, x: jnp.sum(R * sk.sig_gram(k, x, x, **kw)),
        lambda k, x: torch.sum(torch.tensor(R, dtype=x.dtype)
                               * skt.sig_gram(k, x, x, **kw)),
        [X])


@pytest.mark.parametrize("kind,dyadic,naive", CONFIGS)
def test_sig_gram_lincomb_grad(rng, kind, dyadic, naive):
    X, Y, _ = inputs(rng)
    W = _weights(rng, 4, 5)
    kw = dict(dyadic_order=dyadic, naive=naive, pair_chunk=7)  # 20 pairs
    check_grads(
        kind,
        lambda k, x, y, w: sk.sig_gram_lincomb(k, x, y, w, **kw),
        lambda k, x, y, w: skt.sig_gram_lincomb(k, x, y, w, **kw),
        [X, Y, W])


@pytest.mark.parametrize("kind,dyadic,naive", CONFIGS)
def test_sig_gram_lincomb_sym_grad(rng, kind, dyadic, naive):
    X, _, _ = inputs(rng)
    W = _weights(rng, 4, 4)
    kw = dict(dyadic_order=dyadic, naive=naive, pair_chunk=3, sym=True)
    check_grads(
        kind,
        lambda k, x, w: sk.sig_gram_lincomb(k, x, x, w, **kw),
        lambda k, x, w: skt.sig_gram_lincomb(k, x, x, w, **kw),
        [X, W])


@pytest.mark.parametrize("kind", list(HYPER))
def test_length_one_path_grad(rng, kind):
    """A length-1 path has kernel 1 with every partner: its gradients and
    its partners' gradients through it are exactly 0."""
    X = make_paths(rng, 2, 1, 2, scale=0.6)
    Y = make_paths(rng, 3, 6, 2, scale=0.6)
    W = _weights(rng, 2, 3)
    for dtype in (torch.float64, torch.float32):
        tx = torch.tensor(X, dtype=dtype, requires_grad=True)
        ty = torch.tensor(Y, dtype=dtype, requires_grad=True)
        tw = torch.tensor(W, dtype=dtype, requires_grad=True)
        k = getattr(skt, kind)(HYPER[kind])
        S = (skt.sig_gram_lincomb(k, tx, ty, tw, dyadic_order=1)
             + skt.sig_gram(k, tx, ty, dyadic_order=1).sum())
        S.backward()
        assert torch.equal(tx.grad, torch.zeros_like(tx))
        assert torch.equal(ty.grad, torch.zeros_like(ty))
        assert torch.equal(tw.grad, torch.ones_like(tw))


def test_grad_solver_grades_agree_on_the_cpu(rng):
    """On the CPU (the scan family) every grade gives gradients at the
    input precision, as the JAX scan tier does: the same numbers."""
    X, Y, _ = inputs(rng)
    W = torch.tensor(_weights(rng, 4, 5))
    grads = []
    for grade in ("auto", "f32", "df64"):
        x = torch.tensor(X, requires_grad=True)
        sigma = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
        skt.sig_gram_lincomb(skt.RBFKernel(sigma), x, torch.tensor(Y), W,
                             dyadic_order=1, grad_solver=grade).backward()
        assert x.grad.dtype == torch.float64
        grads.append((x.grad, sigma.grad))
    for g in grads[1:]:
        assert torch.equal(g[0], grads[0][0]) and torch.equal(g[1],
                                                               grads[0][1])


def test_no_grad_needed_keeps_no_graph(rng):
    X, Y, _ = inputs(rng)
    k = skt.RBFKernel(0.5)
    W = torch.ones(4, 5, dtype=torch.float64)
    S = skt.sig_gram_lincomb(k, torch.tensor(X), torch.tensor(Y), W)
    assert not S.requires_grad
    with torch.no_grad():
        v = skt.sig_kernel(k, torch.tensor(X, requires_grad=True),
                           torch.tensor(Y[:4]))
    assert not v.requires_grad
