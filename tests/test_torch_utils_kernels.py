"""The port's utilities, static kernels and JAX-leaf conversion against the
JAX package, on the same numpy inputs."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import sigkernel_tpu as sk
from sigkernel_tpu import utils as jutils

import sigkernel_tpu_torch as skt
from sigkernel_tpu_torch import utils as tutils

from conftest import make_paths


def _t(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def test_double_difference_and_increment_grid(rng):
    G = rng.normal(size=(2, 5, 7))
    np.testing.assert_allclose(tutils.double_difference(_t(G)).numpy(),
                               np.asarray(jutils.double_difference(G)),
                               rtol=1e-15, atol=1e-15)
    for d in (0, 1, 2):
        np.testing.assert_allclose(
            tutils.increment_grid(_t(G), d).numpy(),
            np.asarray(jutils.increment_grid(jnp.asarray(G), d)),
            rtol=1e-15, atol=1e-15)


@pytest.mark.parametrize("dyadic", [0, 1, 2])
def test_dyadic_refine(rng, dyadic):
    dd = rng.normal(size=(3, 4, 6))
    got = tutils.dyadic_refine(_t(dd), dyadic).numpy()
    want = np.asarray(jutils.dyadic_refine(jnp.asarray(dd), dyadic))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("multiple", [1, 3, 4, 7])
def test_pad_length_and_pad_batch(rng, multiple):
    X = rng.normal(size=(5, 9, 2))
    np.testing.assert_array_equal(
        tutils.pad_length(_t(X), multiple).numpy(),
        np.asarray(jutils.pad_length(jnp.asarray(X), multiple)))
    got, n = tutils.pad_batch(_t(X), multiple)
    want, m = jutils.pad_batch(jnp.asarray(X), multiple)
    assert n == m == 5
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sizes():
    for x, m in ((0, 8), (1, 8), (8, 8), (9, 128), (300, 128)):
        assert tutils.ceil_to(x, m) == jutils.ceil_to(x, m)
    for length, d in ((1, 0), (10, 0), (10, 2), (1024, 1)):
        assert (tutils.refined_size(length, d)
                == jutils.refined_size(length, d))


_KERNELS = [("RBFKernel", 0.5), ("LinearKernel", 0.7)]


@pytest.mark.parametrize("kind,hyper", _KERNELS)
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-13),
                                        (torch.float32, 1e-5)])
def test_static_kernels_match_jax(rng, kind, hyper, dtype, rtol):
    X = make_paths(rng, 3, 6, 3, scale=0.8)
    Y = make_paths(rng, 3, 9, 3, scale=0.8)
    jk = getattr(sk, kind)(hyper)
    tk = getattr(skt, kind)(hyper)
    np.testing.assert_allclose(
        tk.batch_kernel(_t(X, dtype), _t(Y, dtype)).double().numpy(),
        np.asarray(jk.batch_kernel(X, Y)), rtol=rtol)
    G = tk.Gram_matrix(_t(X, dtype), _t(Y[:2], dtype))
    assert G.shape == (3, 2, 6, 9) and G.dtype == dtype
    np.testing.assert_allclose(G.double().numpy(),
                               np.asarray(jk.Gram_matrix(X, Y[:2])),
                               rtol=rtol)
    np.testing.assert_array_equal(tk.gram_matrix(_t(X), _t(Y)).numpy(),
                                  tk.Gram_matrix(_t(X), _t(Y)).numpy())


def test_linear_gram_applies_scale_squared(rng):
    X = _t(make_paths(rng, 2, 5, 2))
    g1 = skt.LinearKernel(1.0).Gram_matrix(X, X)
    g3 = skt.LinearKernel(3.0).Gram_matrix(X, X)
    torch.testing.assert_close(g3, 9.0 * g1)


def test_hyperparameters_are_buffers():
    k = skt.RBFKernel(0.5)
    assert k.sigma.dtype == torch.float64 and float(k.sigma) == 0.5
    assert "sigma" in k.state_dict() and not list(k.parameters())
    k32 = skt.LinearKernel(2.0, dtype=torch.float32)
    assert k32.scale.dtype == torch.float32
    sig = skt.SigKernel(skt.RBFKernel(0.25), dyadic_order=1)
    assert "static_kernel.sigma" in sig.state_dict()


@pytest.mark.parametrize("kind,hyper", _KERNELS)
def test_convert_from_jax_leaves(rng, kind, hyper):
    jk = getattr(sk, kind)(hyper)
    leaves = [np.asarray(l) for l in jax.tree.flatten(jk)[0]]
    tk = skt.static_kernel_from_numpy(type(jk).__name__, leaves,
                                      dtype=torch.float64)
    assert type(tk) is getattr(skt, kind)
    X = make_paths(rng, 2, 7, 2)
    np.testing.assert_allclose(tk.Gram_matrix(_t(X), _t(X)).numpy(),
                               np.asarray(jk.Gram_matrix(X, X)), rtol=1e-13)


def test_convert_rejects_unknown_kernels():
    with pytest.raises(ValueError, match="RBFKernel"):
        skt.static_kernel_from_numpy("RBF_SQR_Kernel", [np.asarray(1.0)])
    with pytest.raises(ValueError, match="one leaf"):
        skt.static_kernel_from_numpy("RBFKernel", [1.0, 2.0])
