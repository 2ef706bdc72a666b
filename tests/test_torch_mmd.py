"""The port's MMD (both branches), distance and two-sample test against the
same JAX calls, with ``RBFKernel`` and ``LinearKernel``, dyadic orders 0/1/2
and both schemes (helpers and tolerances in ``test_torch_sigkernel``)."""
import jax.numpy as jnp
import pytest

import sigkernel_tpu as sk

import sigkernel_tpu_torch as skt

from test_torch_sigkernel import (CONFIGS, HYPER, RTOL, close, inputs,
                                 kernels, scale_of, t)


@pytest.mark.parametrize("kind,dyadic,naive", CONFIGS)
def test_sig_mmd_both_branches(rng, kind, dyadic, naive):
    jk, tk = kernels(kind)
    X, Y = inputs(rng)
    jX, jY = jnp.asarray(X), jnp.asarray(Y)
    scale = scale_of(tk, Y, dyadic)
    for max_batch in (100, 3):        # the Gram branch, the lincomb branch
        kw = dict(dyadic_order=dyadic, naive=naive, max_batch=max_batch)
        want = sk.sig_mmd(jk, jX, jY, **kw)
        close(lambda dt: skt.sig_mmd(tk, t(X, dt), t(Y, dt), pair_chunk=5,
                                     **kw), want, scale)


@pytest.mark.parametrize("kind,dyadic,naive", CONFIGS)
def test_sig_distance(rng, kind, dyadic, naive):
    jk, tk = kernels(kind)
    X, Y = inputs(rng)
    X = X[:4]
    kw = dict(dyadic_order=dyadic, naive=naive, max_batch=3)
    want = sk.sig_distance(jk, jnp.asarray(X), jnp.asarray(Y), **kw)
    scale = scale_of(tk, Y, dyadic)
    close(lambda dt: skt.sig_distance(tk, t(X, dt), t(Y, dt), **kw), want,
          scale)


@pytest.mark.parametrize("kind", list(HYPER))
@pytest.mark.parametrize("dyadic", [0, 1, 2])
def test_hypothesis_test(rng, kind, dyadic):
    jk, tk = kernels(kind)
    X, Y = inputs(rng)
    Y = 1.5 * Y
    rej, TU, c = sk.hypothesis_test(jnp.asarray(X), jnp.asarray(Y),
                                    sk.SigKernel(jk, dyadic), verbose=False)
    scale = scale_of(tk, Y, dyadic)
    for dtype, rtol in RTOL.items():
        # a static kernel with dyadic_order, or a whole SigKernel
        for args in ((tk,), (skt.SigKernel(tk, dyadic),)):
            got = skt.hypothesis_test(t(X, dtype), t(Y, dtype), *args,
                                      dyadic_order=dyadic, verbose=False)
            assert got[0] == rej
            assert abs(float(got[1]) - float(TU)) <= rtol * scale
            assert got[2] == pytest.approx(c, rel=1e-15)
    assert skt.c_alpha(20, 0.05) == sk.c_alpha(20, 0.05)
