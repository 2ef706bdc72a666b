"""Two-sample hypothesis test on the signature-kernel MMD.

Counterpart of :func:`sigkernel_tpu.stats.hypothesis_test` and
:func:`sigkernel_tpu.stats.c_alpha`.
"""
from __future__ import annotations

import numpy as np

from .sigkernel import SigKernel, sig_mmd


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
    rejected = bool(TU > c)
    if verbose:
        if rejected:
            print(f"Hypothesis rejected: distribution are not equal with "
                  f"{confidence_level * 100}% confidence")
        else:
            print(f"Hypothesis accepted: distribution are equal with "
                  f"{confidence_level * 100}% confidence")
    return rejected, TU, c
