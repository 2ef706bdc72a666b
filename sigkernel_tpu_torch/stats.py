"""Two-sample hypothesis test on the signature-kernel MMD, and the
signature conditional-independence statistic.

Counterpart of :mod:`sigkernel_tpu.stats`: :func:`hypothesis_test`,
:func:`c_alpha`, :func:`sig_chsic` and its alias :data:`SigCHSIC`.
"""
from __future__ import annotations

import numpy as np
import torch

from .sigkernel import SigKernel, sig_gram, sig_mmd
from .tracing import host, span, spanned


def c_alpha(m: int, alpha: float) -> float:
    """MMD two-sample test threshold ``4 sqrt(-log(alpha) / m)``."""
    return 4.0 * np.sqrt(-np.log(alpha) / m)


def _unwrap(static_kernel, dyadic_order):
    """Accept either a static kernel or a whole ``SigKernel``."""
    if isinstance(static_kernel, SigKernel):
        return static_kernel.static_kernel, static_kernel.dyadic_order
    return static_kernel, dyadic_order


def hypothesis_test(y_pred, y_test, static_kernel, confidence_level=0.99,
                    dyadic_order=0, verbose=True):
    """MMD-based two-sample test; returns ``(rejected, mmd_statistic,
    threshold)`` and prints the verdict when ``verbose``."""
    static_kernel, dyadic_order = _unwrap(static_kernel, dyadic_order)
    m = max(y_pred.shape[0], y_test.shape[0])
    TU = sig_mmd(static_kernel, y_pred, y_test, dyadic_order=dyadic_order)
    # c_alpha takes the significance level alpha; the reference passed the
    # confidence level, making its threshold ~20x too small
    c = c_alpha(m, 1.0 - confidence_level)
    rejected = host(TU > c, "verdict")
    if verbose:
        if rejected:
            print(f"Hypothesis rejected: distribution are not equal with "
                  f"{confidence_level * 100}% confidence")
        else:
            print(f"Hypothesis accepted: distribution are equal with "
                  f"{confidence_level * 100}% confidence")
    return rejected, TU, c


@spanned("sk.est.sig_chsic")
def sig_chsic(X, Y, Z, static_kernel, dyadic_order=1, eps=0.1,
              max_batch=100):
    """Signature conditional HSIC statistic of ``X`` and ``Y`` given ``Z``
    (``(batch, length, dim)`` paths) -> a scalar.

    Three ``sym=True`` Grams, centred by ``H = I - 1/m``; the regularised
    inverse ``(K_Z + m eps I)^-1`` by Cholesky. Accepts a whole
    ``SigKernel``. Differentiable in ``X``, ``Y``, ``Z`` and the kernel's
    hyper-parameter by autograd.
    """
    static_kernel, dyadic_order = _unwrap(static_kernel, dyadic_order)
    m = X.shape[0]
    kw = dict(dtype=X.dtype, device=X.device)

    gram = dict(dyadic_order=dyadic_order, sym=True, max_batch=max_batch)
    K_X = sig_gram(static_kernel, X, X, **gram)
    K_Y = sig_gram(static_kernel, Y, Y, **gram)
    K_Z = sig_gram(static_kernel, Z, Z, **gram)

    eye = torch.eye(m, **kw)
    H = eye - torch.full((m, m), 1.0 / m, **kw)
    K_X_ = H @ K_X @ H
    K_Y_ = H @ K_Y @ H
    K_Z_ = H @ K_Z @ H

    K_Z_e = K_Z_ + m * eps * eye
    with span("sk.sync.cholesky"):   # it reads its error code on the host
        L = torch.linalg.cholesky(K_Z_e)
    K_Z_e_inv = torch.cholesky_solve(eye, L)
    K_Z_e_inv2 = K_Z_e_inv @ K_Z_e_inv

    term_1 = torch.trace(K_X_ @ K_Y_)
    A = K_Z_ @ K_Z_e_inv2 @ K_Z_
    B = K_X_ @ A @ K_Y_
    term_2 = torch.trace(B)
    term_3 = torch.trace(B @ A)
    return (term_1 - 2.0 * term_2 + term_3) / m ** 2


# the reference's name
SigCHSIC = sig_chsic
