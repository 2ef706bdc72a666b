"""Carry a JAX static kernel's hyper-parameters over to the port.

The JAX kernels are pytrees whose leaves are their hyper-parameters
(``jax.tree.flatten(k)[0]``): ``(sigma,)`` for ``RBFKernel`` and
``RBF_ID_Kernel``, ``(scale,)`` for ``LinearKernel``, ``(sigma1, sigma2)``
for ``RBF_SQR_Kernel``, ``(sigma1, sigma)`` for ``RBF_CEXP_Kernel`` (whose
``n_freqs`` is the pytree's aux data) and none for ``Linear_ID_Kernel``.
Given those leaves as numpy arrays (or Python numbers),
:func:`static_kernel_from_numpy` builds the port's module.
"""
from __future__ import annotations

import numpy as np
import torch

from . import kernels

# JAX class name -> (the port's class, number of pytree leaves)
_KINDS = {
    "RBFKernel": (kernels.RBFKernel, 1),
    "LinearKernel": (kernels.LinearKernel, 1),
    "RBF_ID_Kernel": (kernels.RBF_ID_Kernel, 1),
    "RBF_SQR_Kernel": (kernels.RBF_SQR_Kernel, 2),
    "RBF_CEXP_Kernel": (kernels.RBF_CEXP_Kernel, 2),
    "Linear_ID_Kernel": (kernels.Linear_ID_Kernel, 0),
}


def static_kernel_from_numpy(kind: str, leaves, *, n_freqs=None,
                             dtype=torch.float64, device=None,
                             requires_grad=False):
    """``kind``: the JAX class name; ``leaves``: its flattened pytree leaves,
    in the pytree's order; ``n_freqs``: ``RBF_CEXP_Kernel``'s aux data.
    ``requires_grad``: make every hyper-parameter a trainable leaf (its
    gradient lands in its ``.grad``)."""
    if kind not in _KINDS:
        raise ValueError(f"unknown static kernel {kind!r}; expected one of "
                         f"{tuple(_KINDS)}")
    cls, n_leaves = _KINDS[kind]
    leaves = list(leaves)
    if len(leaves) != n_leaves:
        raise ValueError(f"{kind} takes {n_leaves} leaf value(s); got "
                         f"{len(leaves)}")
    if (n_freqs is None) != (kind != "RBF_CEXP_Kernel"):
        raise ValueError("n_freqs is RBF_CEXP_Kernel's and only its: give "
                         "it for that kind alone")
    values = [torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
              for v in leaves]
    for v in values:
        v.requires_grad_(requires_grad)
    if n_freqs is not None:
        return cls(*values, n_freqs)
    if not values:
        return cls(dtype=dtype, device=device)
    return cls(*values)
