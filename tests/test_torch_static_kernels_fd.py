"""The functional-data static kernels (``cos_exp_kernel``, ``CEXP``,
``RBF_CEXP_Kernel``, ``RBF_SQR_Kernel``, ``Linear_ID_Kernel``,
``RBF_ID_Kernel``) against the JAX package on the same numpy inputs of shape
``(batch, length_t, length_x, dim)``: ``batch_kernel`` and ``Gram_matrix``,
the gradients of their hyper-parameters, a signature-kernel Gram through
each, and ``convert.static_kernel_from_numpy`` for each kind.

Bars: static-kernel values float64 1e-13 and float32 1e-5 relative (the two
packages' einsums sum in other orders); signature-kernel values float64
1e-10 relative; gradients float64 within 1e-9 of max |ref|."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigkernel_tpu as sk

import sigkernel_tpu_torch as skt
from sigkernel_tpu_torch.ops import routes

# name -> (JAX kernel, port kernel) from the same hyper-parameters
_FD = {
    "rbf_cexp": lambda m, *h: m.RBF_CEXP_Kernel(*h, 4),
    "rbf_sqr": lambda m, *h: m.RBF_SQR_Kernel(*h),
    "linear_id": lambda m, *h: m.Linear_ID_Kernel(),
    "rbf_id": lambda m, *h: m.RBF_ID_Kernel(h[0]),
}
_HYPER = {"rbf_cexp": (1.3, 0.8), "rbf_sqr": (0.9, 1.7), "linear_id": (),
          "rbf_id": (0.6,)}


def _functions(rng, batch, length_t, length_x=5, dim=2, scale=0.6):
    """Function values on a grid: cumulative in time, smooth in x."""
    steps = rng.normal(size=(batch, length_t, length_x, dim))
    return np.cumsum(steps * scale / np.sqrt(length_t), axis=1)


def _t(a, dtype=torch.float64, grad=False):
    return torch.tensor(np.asarray(a), dtype=dtype, requires_grad=grad)


def _rel(got, want):
    want = np.asarray(want)
    return np.max(np.abs(got.detach().double().numpy() - want)
                  / np.abs(want))


def _close(got, want, bar=1e-9):
    want = np.asarray(want)
    got = got.detach().double().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= bar * max(np.abs(want).max(), 1e-300)


def test_cos_exp_kernel_and_cexp_match_jax(rng):
    x_y = rng.uniform(-1.0, 1.0, size=(6, 6))
    np.testing.assert_allclose(
        skt.cos_exp_kernel(_t(x_y), n_freqs=4, sigma=0.7).numpy(),
        np.asarray(sk.cos_exp_kernel(jnp.asarray(x_y), n_freqs=4, sigma=0.7)),
        rtol=1e-13, atol=1e-15)
    F = _functions(rng, 2, 4)
    got = skt.CEXP(_t(F), n_freqs=3, sigma=1.1)
    want = np.asarray(sk.CEXP(jnp.asarray(F), n_freqs=3, sigma=1.1))
    assert got.shape == want.shape == F.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-15)


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-13),
                                        (torch.float32, 1e-5)])
@pytest.mark.parametrize("kind", sorted(_FD))
def test_functional_kernels_match_jax(rng, kind, dtype, rtol):
    X, Y = _functions(rng, 3, 6), _functions(rng, 3, 8)
    jk = _FD[kind](sk, *_HYPER[kind])
    tk = _FD[kind](skt, *_HYPER[kind])
    got = tk.batch_kernel(_t(X, dtype), _t(Y, dtype))
    assert got.shape == (3, 6, 8) and got.dtype == dtype
    np.testing.assert_allclose(
        got.double().numpy(),
        np.asarray(jk.batch_kernel(jnp.asarray(X), jnp.asarray(Y))),
        rtol=rtol, atol=rtol * 1e-3)
    G = tk.Gram_matrix(_t(X, dtype), _t(Y[:2], dtype))
    assert G.shape == (3, 2, 6, 8) and G.dtype == dtype
    np.testing.assert_allclose(
        G.double().numpy(),
        np.asarray(jk.Gram_matrix(jnp.asarray(X), jnp.asarray(Y[:2]))),
        rtol=rtol, atol=rtol * 1e-3)


@pytest.mark.parametrize("kind", ["rbf_cexp", "rbf_sqr", "rbf_id"])
def test_hyperparameter_gradients_match_jax(rng, kind):
    """The hyper-parameters are tensors that take gradients, as the JAX
    pytree leaves do."""
    X, Y = _functions(rng, 2, 5), _functions(rng, 3, 4)
    hyper = _HYPER[kind]

    def jloss(h, x):
        return jnp.sum(jnp.sin(_FD[kind](sk, *h).Gram_matrix(
            x, jnp.asarray(Y))))

    want = jax.grad(jloss, argnums=(0, 1))(
        tuple(jnp.asarray(v) for v in hyper), jnp.asarray(X))
    th = [_t(v, grad=True) for v in hyper]
    x = _t(X, grad=True)
    torch.sin(_FD[kind](skt, *th).Gram_matrix(x, _t(Y))).sum().backward()
    for t, w in zip(th + [x], list(want[0]) + [want[1]]):
        _close(t.grad, w)


@pytest.mark.parametrize("kind", sorted(_FD))
def test_signature_gram_through_functional_kernels(rng, kind):
    """Values of a signature-kernel Gram and its gradient in the paths; on
    CUDA these kernels take the ``inc`` family (K2), never a generator."""
    assert routes.resolve_family(_FD[kind](skt, *_HYPER[kind]), "cuda",
                                 "auto") == "inc"
    X, Y = _functions(rng, 3, 7), _functions(rng, 2, 5)
    jk = _FD[kind](sk, *_HYPER[kind])

    def jgram(x):
        return sk.sig_gram(jk, x, jnp.asarray(Y), dyadic_order=1)

    want = jgram(jnp.asarray(X))
    want_dx = jax.grad(lambda x: jnp.sum(jnp.cos(jgram(x))))(jnp.asarray(X))
    x = _t(X, grad=True)
    K = skt.sig_gram(_FD[kind](skt, *_HYPER[kind]), x, _t(Y), dyadic_order=1)
    assert K.shape == (3, 2)
    assert _rel(K, want) <= 1e-10
    torch.cos(K).sum().backward()
    _close(x.grad, want_dx)


@pytest.mark.parametrize("kind", sorted(_FD))
def test_convert_functional_kinds_from_jax_leaves(rng, kind):
    jk = _FD[kind](sk, *_HYPER[kind])
    leaves, aux = jax.tree.flatten(jk)
    kw = {"n_freqs": 4} if kind == "rbf_cexp" else {}
    tk = skt.static_kernel_from_numpy(type(jk).__name__,
                                      [np.asarray(v) for v in leaves], **kw)
    assert type(tk) is type(_FD[kind](skt, *_HYPER[kind]))
    X = _functions(rng, 2, 5)
    np.testing.assert_allclose(
        tk.Gram_matrix(_t(X), _t(X)).numpy(),
        np.asarray(jk.Gram_matrix(jnp.asarray(X), jnp.asarray(X))),
        rtol=1e-13, atol=1e-15)
    if leaves:  # trainable on request
        tk = skt.static_kernel_from_numpy(type(jk).__name__,
                                          [np.asarray(v) for v in leaves],
                                          requires_grad=True, **kw)
        assert all(b.requires_grad for b in tk.buffers())


def test_convert_checks_leaves_and_n_freqs():
    with pytest.raises(ValueError, match="2 leaf value"):
        skt.static_kernel_from_numpy("RBF_SQR_Kernel", [1.0])
    with pytest.raises(ValueError, match="0 leaf value"):
        skt.static_kernel_from_numpy("Linear_ID_Kernel", [1.0])
    with pytest.raises(ValueError, match="n_freqs"):
        skt.static_kernel_from_numpy("RBF_CEXP_Kernel", [1.0, 0.5])
    with pytest.raises(ValueError, match="n_freqs"):
        skt.static_kernel_from_numpy("RBF_ID_Kernel", [1.0], n_freqs=3)
