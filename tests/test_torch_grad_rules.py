"""Gradients of the port's distance and scoring rules, and of the
``SigKernel`` methods, against ``jax.grad`` of the same JAX calls on the same
numpy inputs (helpers and bars in ``test_torch_grad.py``). The scoring rules
run both branches: whole Grams, and the bounded-memory lincomb route that a
small ``max_batch`` selects."""
import jax
import jax.numpy as jnp
import pytest
import torch

import sigkernel_tpu as sk

import sigkernel_tpu_torch as skt

from test_torch_grad import CONFIGS, HYPER, check_grads, inputs


@pytest.mark.parametrize("kind,dyadic,naive", CONFIGS)
def test_sig_distance_grad(rng, kind, dyadic, naive):
    X, _, Y4 = inputs(rng)
    kw = dict(dyadic_order=dyadic, naive=naive, max_batch=3)
    check_grads(kind,
                lambda k, x, y: sk.sig_distance(k, x, y, **kw),
                lambda k, x, y: skt.sig_distance(k, x, y, **kw),
                [X, Y4])


@pytest.mark.parametrize("max_batch", [100, 3])
@pytest.mark.parametrize("rule", ["sig_scoring_rule",
                                  "sig_expected_scoring_rule"])
@pytest.mark.parametrize("kind", list(HYPER))
def test_scoring_rules_grad(rng, kind, rule, max_batch):
    X, Y, _ = inputs(rng)
    y = Y[:1] if rule == "sig_scoring_rule" else Y
    kw = dict(dyadic_order=1, max_batch=max_batch, pair_chunk=5)
    check_grads(kind,
                lambda k, x, yy: getattr(sk, rule)(k, x, yy, **kw),
                lambda k, x, yy: getattr(skt, rule)(k, x, yy, **kw),
                [X, y])


@pytest.mark.parametrize("method", ["compute_kernel", "compute_Gram",
                                    "compute_distance", "compute_mmd",
                                    "compute_scoring_rule",
                                    "compute_expected_scoring_rule"])
def test_sigkernel_methods_grad(rng, method):
    X, _, Y4 = inputs(rng)

    def loss(mod, k, x, y):
        out = getattr(mod.SigKernel(k, dyadic_order=1), method)(x, y,
                                                                max_batch=3)
        return out.sum()

    check_grads("RBFKernel", lambda k, x, y: loss(sk, k, x, y),
                lambda k, x, y: loss(skt, k, x, y), [X, Y4])


def test_sigma_gradient_lands_in_the_buffer(rng):
    """``RBFKernel(sigma)`` with ``sigma.requires_grad_()``: the gradient of
    a loss in sigma lands in ``.grad`` of the tensor the kernel holds, and
    equals JAX's."""
    X, Y, _ = inputs(rng)
    sigma = torch.tensor(0.5, dtype=torch.float64).requires_grad_()
    k = skt.RBFKernel(sigma)
    assert k.sigma is sigma
    skt.sig_mmd(k, torch.tensor(X), torch.tensor(Y), dyadic_order=1).backward()
    g = jax.grad(lambda s: sk.sig_mmd(sk.RBFKernel(s), jnp.asarray(X),
                                      jnp.asarray(Y), dyadic_order=1))(
        jnp.asarray(0.5))
    assert float(g) != 0.0
    assert abs(float(sigma.grad) - float(g)) <= 1e-9 * abs(float(g))
