"""The port's MMD particle flow (``models.mmd_flow``) against the JAX
package's ``mmd_flow_step`` over three steps on the same numpy paths, and its
checkpoint and resume."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigkernel_tpu as sk
from sigkernel_tpu.models import mmd_flow as jflow

import sigkernel_tpu_torch as skt
from sigkernel_tpu_torch.models import mmd_flow

from conftest import make_paths


@pytest.mark.parametrize("kind,hyper,dyadic", [("RBFKernel", 0.5, 1),
                                               ("LinearKernel", 0.8, 0)])
def test_three_steps_match_jax(rng, kind, hyper, dyadic):
    X0 = make_paths(rng, 4, 8, 2, scale=0.6)
    Y = make_paths(rng, 5, 10, 2, scale=0.9)
    jk, tk = getattr(sk, kind)(hyper), getattr(skt, kind)(hyper)
    jX, tX = jnp.asarray(X0), torch.tensor(X0)
    for _ in range(3):
        jX, jv = jflow.mmd_flow_step(jk, jX, jnp.asarray(Y), lr=0.5,
                                     dyadic_order=dyadic)
        tX, tv = mmd_flow.mmd_flow_step(tk, tX, torch.tensor(Y), lr=0.5,
                                        dyadic_order=dyadic)
        assert not tX.requires_grad and not tv.requires_grad
        assert abs(float(tv) - float(jv)) <= 1e-10 * abs(float(jv))
        step = np.abs(np.asarray(jX) - X0).max()
        assert np.abs(tX.numpy() - np.asarray(jX)).max() <= 1e-9 * step


def test_fit_lowers_the_mmd(rng):
    X0 = torch.tensor(make_paths(rng, 4, 6, 2, scale=0.3))
    Y = torch.tensor(make_paths(rng, 4, 6, 2, scale=0.9))
    X, history = skt.MMDFlow(skt.RBFKernel(0.5), lr=1.0).fit(X0, Y,
                                                             n_steps=4)
    assert X.shape == X0.shape and len(history) == 4
    assert all(np.isfinite(history)) and history[-1] < history[0]


def test_resumed_fit_equals_an_unbroken_one(rng, tmp_path):
    X0 = torch.tensor(make_paths(rng, 3, 6, 2, scale=0.3))
    Y = torch.tensor(make_paths(rng, 3, 7, 2, scale=0.9))
    k = skt.RBFKernel(0.5)
    X_full, h_full = skt.MMDFlow(k, lr=0.5).fit(X0, Y, n_steps=5)
    ckpt = tmp_path / "ckpt"
    flow = skt.MMDFlow(k, lr=0.5, checkpoint_dir=str(ckpt),
                       checkpoint_every=2)
    flow.fit(X0, Y, n_steps=3)  # saves steps 1 and 2
    assert sorted(p.name for p in ckpt.iterdir()) == ["step_00000001",
                                                      "step_00000002"]
    X_res, h_res = skt.MMDFlow(k, lr=0.5, checkpoint_dir=str(ckpt),
                               checkpoint_every=2).fit(X0, Y, n_steps=5)
    assert torch.equal(X_res, X_full)
    assert h_res == h_full
    assert (ckpt / "step_00000004").exists()
