"""The signature conditional-independence statistic ``sig_chsic`` /
``SigCHSIC`` against ``sigkernel_tpu.stats.sig_chsic`` on the same numpy
inputs: its value, its gradients in X, Y, Z and sigma against ``jax.grad``,
and the unwrapping of a whole ``SigKernel``.

Bars: float64 value within 1e-10 relative, gradients within 1e-9 of
max |grad|; float32 inputs within 1e-4 relative of JAX in float64."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigkernel_tpu as sk
from sigkernel_tpu import stats as jstats

import sigkernel_tpu_torch as skt

from conftest import make_paths
from test_torch_adjoint import _close


def _xyz(rng, m=5):
    """Y depends on X, Z on both, so the statistic is away from 0."""
    X = make_paths(rng, m, 9, 2, scale=0.8)
    Y = 0.7 * X[:, ::-1] + make_paths(rng, m, 9, 2, scale=0.5)
    Z = make_paths(rng, m, 7, 3, scale=0.8)
    return X, np.ascontiguousarray(Y), Z


@pytest.mark.parametrize("dyadic", [0, 1])
def test_value_and_gradients_match_jax(rng, dyadic):
    X, Y, Z = _xyz(rng)

    def jstat(x, y, z, s):
        return jstats.sig_chsic(x, y, z, sk.RBFKernel(s),
                                dyadic_order=dyadic, eps=0.1)

    args = [jnp.asarray(a) for a in (X, Y, Z)] + [jnp.asarray(0.9)]
    want = float(jstat(*args))
    want_g = jax.grad(jstat, argnums=(0, 1, 2, 3))(*args)
    ts = [torch.tensor(a, requires_grad=True) for a in (X, Y, Z)]
    sigma = torch.tensor(0.9, dtype=torch.float64, requires_grad=True)
    got = skt.sig_chsic(*ts, skt.RBFKernel(sigma), dyadic_order=dyadic,
                        eps=0.1)
    assert got.shape == () and got.dtype == torch.float64
    assert abs(float(got.detach()) - want) <= 1e-10 * abs(want)
    got.backward()
    for t, w in zip(ts + [sigma], want_g):
        _close(t.grad, w)


def test_sigkernel_unwrap_alias_and_float32(rng):
    """A whole ``SigKernel`` takes its static kernel and dyadic order; the
    reference name is the same function; float32 inputs stay float32."""
    X, Y, Z = _xyz(rng, m=4)
    want = float(jstats.SigCHSIC(
        *(jnp.asarray(a) for a in (X, Y, Z)),
        sk.SigKernel(sk.LinearKernel(0.8), dyadic_order=2), max_batch=3))
    assert skt.SigCHSIC is skt.sig_chsic
    tX, tY, tZ = (torch.tensor(a) for a in (X, Y, Z))
    sig = skt.SigKernel(skt.LinearKernel(0.8), dyadic_order=2)
    got = skt.SigCHSIC(tX, tY, tZ, sig, dyadic_order=0, max_batch=3)
    assert abs(float(got) - want) <= 1e-10 * abs(want)
    f32 = skt.sig_chsic(tX.float(), tY.float(), tZ.float(), sig)
    assert f32.dtype == torch.float32
    assert abs(float(f32) - want) <= 1e-4 * abs(want)
