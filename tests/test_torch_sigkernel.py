"""The port's estimators against the same JAX calls on the same numpy paths:
kernel, Gram, Gram linear combination and the ``SigKernel`` module here, MMD,
distance and the two-sample test in ``test_torch_mmd.py`` (which shares the
helpers below).

Every estimator runs with ``RBFKernel`` and ``LinearKernel``, dyadic orders
0/1/2 and both schemes. float64 is held at rtol 1e-10 and float32 at rtol
1e-4 against JAX float64. On the CPU both packages take their plain (scan)
tiers. Scalars that are differences of Gram means (MMD, distance) are held
to the same tolerances relative to the Gram's scale.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import sigkernel_tpu as sk

import sigkernel_tpu_torch as skt

from conftest import make_paths

RTOL = {torch.float64: 1e-10, torch.float32: 1e-4}
HYPER = {"RBFKernel": 0.5, "LinearKernel": 0.8}
CONFIGS = [(kind, dyadic, naive) for kind in HYPER for dyadic in (0, 1, 2)
           for naive in (False, True)]


def kernels(kind):
    return getattr(sk, kind)(HYPER[kind]), getattr(skt, kind)(HYPER[kind])


def inputs(rng, D=2):
    """X (5, 10, D), Y (4, 20, D): unequal lengths, batches that
    ``max_batch=3`` does not divide."""
    return (make_paths(rng, 5, 10, D, scale=0.6),
            make_paths(rng, 4, 20, D, scale=0.6))


def close(port_fn, want, scale=None):
    """``port_fn(dtype)`` against the JAX f64 value ``want``; with
    ``scale`` the error is measured against it instead of ``want``."""
    want = np.asarray(want)
    for dtype, rtol in RTOL.items():
        got = port_fn(dtype)
        assert got.dtype == dtype
        got = got.double().numpy()
        assert got.shape == want.shape
        if scale is None:
            np.testing.assert_allclose(got, want, rtol=rtol)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def t(a, dtype):
    return torch.tensor(a, dtype=dtype)


def scale_of(tk, Y, dyadic):
    """The Gram's scale, ``max |k(Y, Y)|``, for differences of its means."""
    Y = t(Y, torch.float64)
    return float(skt.sig_gram(tk, Y, Y, dyadic_order=dyadic).abs().max())


@pytest.mark.parametrize("kind,dyadic,naive", CONFIGS)
def test_sig_kernel(rng, kind, dyadic, naive):
    jk, tk = kernels(kind)
    X, Y = inputs(rng, D=3)
    X = X[:4]
    want = sk.sig_kernel(jk, jnp.asarray(X), jnp.asarray(Y),
                         dyadic_order=dyadic, naive=naive, max_batch=3)
    close(lambda dt: skt.sig_kernel(tk, t(X, dt), t(Y, dt),
                                    dyadic_order=dyadic, naive=naive,
                                    max_batch=3), want)


@pytest.mark.parametrize("kind,dyadic,naive", CONFIGS)
def test_sig_gram(rng, kind, dyadic, naive):
    jk, tk = kernels(kind)
    X, Y = inputs(rng)
    kw = dict(dyadic_order=dyadic, naive=naive, max_batch=3)
    want = sk.sig_gram(jk, jnp.asarray(X), jnp.asarray(Y), **kw)
    close(lambda dt: skt.sig_gram(tk, t(X, dt), t(Y, dt), **kw), want)
    want = sk.sig_gram(jk, jnp.asarray(X), jnp.asarray(X), sym=True, **kw)
    close(lambda dt: skt.sig_gram(tk, t(X, dt), t(X, dt), sym=True, **kw),
          want)
    K = skt.sig_gram(tk, t(X, torch.float32), t(X, torch.float32),
                     sym=True, **kw)
    assert torch.equal(K, K.T)


@pytest.mark.parametrize("kind,dyadic,naive", CONFIGS)
def test_sig_gram_lincomb(rng, kind, dyadic, naive):
    jk, tk = kernels(kind)
    X, Y = inputs(rng)
    kw = dict(dyadic_order=dyadic, naive=naive, pair_chunk=7)
    W = rng.uniform(0.1, 1.0, size=(5, 4))
    want = sk.sig_gram_lincomb(jk, jnp.asarray(X), jnp.asarray(Y),
                               jnp.asarray(W), **kw)
    close(lambda dt: skt.sig_gram_lincomb(tk, t(X, dt), t(Y, dt),
                                          t(W, dt), **kw), want)
    Ws = rng.uniform(0.1, 1.0, size=(5, 5))
    want = sk.sig_gram_lincomb(jk, jnp.asarray(X), jnp.asarray(X),
                               jnp.asarray(Ws), sym=True, **kw)
    close(lambda dt: skt.sig_gram_lincomb(tk, t(X, dt), t(X, dt),
                                          t(Ws, dt), sym=True, **kw), want)


@pytest.mark.parametrize("kind", list(HYPER))
@pytest.mark.parametrize("naive", [False, True])
def test_sigkernel_methods(rng, kind, naive):
    jk, tk = kernels(kind)
    X, Y = inputs(rng, D=3)
    js = sk.SigKernel(jk, 1, _naive_solver=naive)
    ts = skt.SigKernel(tk, 1, _naive_solver=naive)
    jX, jY = jnp.asarray(X), jnp.asarray(Y)
    scale = scale_of(tk, Y, 1)
    close(lambda dt: ts.compute_kernel(t(X[:4], dt), t(Y, dt), 3),
          js.compute_kernel(jX[:4], jY, 3))
    close(lambda dt: ts.compute_Gram(t(X, dt), t(Y, dt), max_batch=3),
          js.compute_Gram(jX, jY, max_batch=3))
    close(lambda dt: ts.compute_Gram(t(X, dt), t(X, dt), sym=True),
          js.compute_Gram(jX, jX, sym=True))
    close(lambda dt: ts.compute_distance(t(X[:4], dt), t(Y, dt)),
          js.compute_distance(jX[:4], jY), scale)
    close(lambda dt: ts.compute_mmd(t(X, dt), t(Y, dt), max_batch=3),
          js.compute_mmd(jX, jY, max_batch=3), scale)


@pytest.mark.parametrize("kind", list(HYPER))
def test_length_one_paths_and_length_bucket(rng, kind):
    jk, tk = kernels(kind)
    X1 = make_paths(rng, 3, 1, 2)
    Y = make_paths(rng, 4, 7, 2)
    for dyadic in (0, 2):
        want = sk.sig_gram(jk, jnp.asarray(X1), jnp.asarray(Y),
                           dyadic_order=dyadic)
        close(lambda dt: skt.sig_gram(tk, t(X1, dt), t(Y, dt),
                                      dyadic_order=dyadic), want)
    # padding by the last point is exact
    want = sk.sig_kernel(jk, jnp.asarray(Y[:3]), jnp.asarray(Y[1:]),
                         dyadic_order=1)
    close(lambda dt: skt.sig_kernel(tk, t(Y[:3], dt), t(Y[1:], dt),
                                    dyadic_order=1, length_bucket=5), want)


def test_unknown_solvers_raise(rng):
    X = torch.tensor(make_paths(rng, 2, 5, 2))
    k = skt.LinearKernel(1.0)
    for fn in (skt.sig_kernel, skt.sig_gram, skt.sig_mmd, skt.sig_distance):
        with pytest.raises(ValueError, match="'auto', 'scan', 'cuda'"):
            fn(k, X, X, solver="pallas")
        with pytest.raises(ValueError, match="grad_solver"):
            fn(k, X, X, grad_solver="bogus")
    with pytest.raises(ValueError, match="CUDA"):
        skt.sig_gram(k, X, X, solver="cuda")
    with pytest.raises(ValueError, match="pair_chunk"):
        skt.sig_gram_lincomb(k, X, X, torch.ones(2, 2, dtype=X.dtype),
                             pair_chunk=0)
    with pytest.raises(ValueError, match="sym=True"):
        skt.sig_gram_lincomb(k, X, X[:, :3], torch.ones(2, 2), sym=True)
