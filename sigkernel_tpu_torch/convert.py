"""Carry a JAX static kernel's hyper-parameters over to the port.

The JAX kernels are pytrees whose leaves are their hyper-parameters
(``jax.tree.flatten(k)[0]``: ``(sigma,)`` for ``RBFKernel``, ``(scale,)``
for ``LinearKernel``). Given those leaves as numpy arrays (or Python
numbers), :func:`static_kernel_from_numpy` builds the port's module.
"""
from __future__ import annotations

import numpy as np
import torch

from .kernels import LinearKernel, RBFKernel

_KINDS = {"RBFKernel": RBFKernel, "LinearKernel": LinearKernel}


def static_kernel_from_numpy(kind: str, leaves, *, dtype=torch.float64,
                             device=None):
    """``kind``: the JAX class name (``"RBFKernel"`` or ``"LinearKernel"``);
    ``leaves``: its flattened pytree leaves."""
    if kind not in _KINDS:
        raise ValueError(f"unknown static kernel {kind!r}; expected one of "
                         f"{tuple(_KINDS)}")
    leaves = list(leaves)
    if len(leaves) != 1:
        raise ValueError(f"{kind} has one leaf; got {len(leaves)}")
    value = torch.as_tensor(np.asarray(leaves[0]), dtype=dtype, device=device)
    return _KINDS[kind](value)
