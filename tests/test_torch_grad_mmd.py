"""Gradients of the port's MMD against ``jax.grad`` of the same JAX call on
the same numpy inputs (helpers and bars in ``test_torch_grad.py``), in both
branches: whole Grams, and the bounded-memory lincomb route that a small
``max_batch`` selects."""
import pytest

import sigkernel_tpu as sk

import sigkernel_tpu_torch as skt

from test_torch_grad import CONFIGS, check_grads, inputs


@pytest.mark.parametrize("max_batch", [100, 2])
@pytest.mark.parametrize("kind,dyadic,naive", CONFIGS)
def test_sig_mmd_grad(rng, kind, dyadic, naive, max_batch):
    X, Y, _ = inputs(rng)
    kw = dict(dyadic_order=dyadic, naive=naive, max_batch=max_batch)
    if max_batch == 2:
        kw["pair_chunk"] = 4
    check_grads(kind,
                lambda k, x, y: sk.sig_mmd(k, x, y, **kw),
                lambda k, x, y: skt.sig_mmd(k, x, y, **kw),
                [X, Y])
