"""Signature-MMD gradient flow: a trainable generative model over paths.

Counterpart of :mod:`sigkernel_tpu.models.mmd_flow`: a particle flow
``X <- X - lr * grad_X MMD^2(X, Y)`` matching a target path distribution
``Y``. The gradient runs through the adjoint PDE (on the card: K1-stack,
K3<gen> and K4 for ``RBFKernel``). Checkpoints are ``torch.save`` files of
``{"X", "history"}`` named ``step_%08d`` in ``checkpoint_dir``.
"""
from __future__ import annotations

import os
import re

import torch

from ..sigkernel import sig_mmd


def mmd_flow_step(static_kernel, X, Y, lr=0.05, dyadic_order=0, naive=False,
                  solver="auto"):
    """One explicit-Euler step of the signature-MMD particle flow.

    Returns ``(X_next, mmd_value)``, both detached.
    """
    x = X.detach().requires_grad_()
    value = sig_mmd(static_kernel, x, Y, dyadic_order=dyadic_order,
                    naive=naive, solver=solver, max_batch=None)
    (grad,) = torch.autograd.grad(value, x)
    return (x - lr * grad).detach(), value.detach()


class MMDFlow:
    """Runs the flow for ``n_steps``.

    With ``checkpoint_dir`` the particles and the history are saved every
    ``checkpoint_every`` steps and at the last step, and ``fit`` resumes from
    the latest step found there.
    """

    def __init__(self, static_kernel, dyadic_order=0, lr=0.05,
                 naive=False, solver="auto", checkpoint_dir=None,
                 checkpoint_every=10):
        self.static_kernel = static_kernel
        self.dyadic_order = dyadic_order
        self.lr = lr
        self.naive = naive
        self.solver = solver
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every

    def _ckpt_path(self, step):
        return os.path.join(self.checkpoint_dir, f"step_{step:08d}")

    def _latest_step(self):
        if not (self.checkpoint_dir and os.path.isdir(self.checkpoint_dir)):
            return None
        steps = [int(m.group(1)) for f in os.listdir(self.checkpoint_dir)
                 if (m := re.fullmatch(r"step_(\d{8})", f))]
        return max(steps) if steps else None

    def fit(self, X0, Y, n_steps=100, callback=None):
        """Returns ``(X, history)``: the particles after ``n_steps`` steps
        and the MMD before each step, as floats."""
        X = X0.detach()
        history = []
        start = 0
        latest = self._latest_step()
        if latest is not None:
            state = torch.load(self._ckpt_path(latest), map_location=X.device)
            X = state["X"].to(X)
            history = [float(v) for v in state["history"]]
            start = latest + 1
        for t in range(start, n_steps):
            X, value = mmd_flow_step(
                self.static_kernel, X, Y, lr=self.lr,
                dyadic_order=self.dyadic_order, naive=self.naive,
                solver=self.solver)
            history.append(float(value))
            if callback is not None:
                callback(t, X, value)
            if (self.checkpoint_dir is not None
                    and ((t + 1) % self.checkpoint_every == 0
                         or t == n_steps - 1)):
                os.makedirs(self.checkpoint_dir, exist_ok=True)
                torch.save({"X": X.cpu(),
                            "history": torch.tensor(history,
                                                    dtype=torch.float64)},
                           self._ckpt_path(t))
        return X, history
