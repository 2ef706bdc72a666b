"""K4: the increment-chain VJP of the RBF generation
(``csrc/rbf_dd_vjp.cu``).

Replaces ``sigkernel_tpu/ops/pallas_incvjp.py`` (``_vjp_kernel``): given the
cotangent ``ct`` ``(P, M-1, N-1)`` of the base increments
``dd(exp(-|x_m - y_n|^2 / sigma))`` of the pairs ``(X[ii[p]], Y[jj[p]])``,
it returns the gradients in ``sigma``, ``X`` and ``Y``. The per-pair path
gradients go back onto ``X`` and ``Y`` with ``index_add_`` over ``ii`` and
``jj``, so one call serves pairwise kernels, Grams, the symmetric triangle
and the linear-combination chunks.

:func:`rbf_dd_vjp` launches the kernel for CUDA tensors and takes
:func:`rbf_dd_vjp_plain` (a port of ``sigkernel_tpu/ops/df_prep.py``'s
``rbf_dd_vjp``, pairwise layout) only for CPU tensors. ``COUNTS`` holds the
kernel launches per dtype and the calls of the plain version.
"""
from __future__ import annotations

import torch

from . import _build, cuda_gen
from ..utils import dd_transpose

COUNTS = {"float32": 0, "float64": 0, "plain": 0}

_FNS = {torch.float32: "sk_rbf_dd_vjp_f32",
        torch.float64: "sk_rbf_dd_vjp_f64"}
_THREADS = 128  # kVjpThreads in csrc/rbf_dd_vjp.cu

# the plain version runs pairs in chunks whose (M, N) grids stay near this
_PLAIN_CHUNK_BYTES = 1 << 30


def _sigma(sigma, t) -> torch.Tensor:
    """``sigma`` as a value of ``t``'s dtype, rounded as the kernel rounds
    the double it is given."""
    return torch.as_tensor(cuda_gen.sigma_value(sigma), dtype=t.dtype,
                           device=t.device)


def vjp_pairs_plain(x, y, sigma, ct):
    """The VJP for the pairs ``(x[p], y[p])``: ``(sum over pairs of
    E * D, dx (P, M, D), dy (P, N, D))``, with ``dG = dd^T(ct)``,
    ``E = dG * exp(-D / sigma)``, ``W = -E / sigma``."""
    dG = dd_transpose(ct)
    dist = cuda_gen.sqdist(x, y)
    E = dG * torch.exp(-dist / sigma)
    W = E * (-1.0 / sigma)
    dx = 2.0 * (torch.sum(W, -1)[..., None] * x - torch.bmm(W, y))
    dy = 2.0 * (torch.sum(W, -2)[..., None] * y
                - torch.bmm(W.transpose(-1, -2), x))
    return torch.sum(E * dist), dx, dy


def rbf_dd_vjp_plain(X, Y, ii, jj, sigma, ct):
    """Plain version: :func:`vjp_pairs_plain` over chunks of pairs, then
    ``index_add_`` onto ``X`` and ``Y``."""
    COUNTS["plain"] += 1
    sig = _sigma(sigma, X)
    M, N = X.shape[1], Y.shape[1]
    chunk = max(1, _PLAIN_CHUNK_BYTES // (6 * M * N * X.element_size()))
    es = X.new_zeros(())
    dX, dY = torch.zeros_like(X), torch.zeros_like(Y)
    for s in range(0, ii.shape[0], chunk):
        ic, jc = ii[s:s + chunk], jj[s:s + chunk]
        e, dx, dy = vjp_pairs_plain(X[ic], Y[jc], sig, ct[s:s + chunk])
        es = es + e
        dX.index_add_(0, ic, dx)
        dY.index_add_(0, jc, dy)
    return es / (sig * sig), dX, dY


def rbf_dd_vjp(X, Y, ii, jj, sigma, ct):
    """``(d sigma, dX, dY)`` of ``sum(ct * dd(exp(-|x - y|^2 / sigma)))``
    over the pairs ``(X[ii[p]], Y[jj[p]])``; ``ct``: ``(P, M-1, N-1)`` in
    the dtype of the paths. ``d sigma`` is a 0-d tensor of that dtype."""
    if X.device.type == "cpu":
        return rbf_dd_vjp_plain(X, Y, ii, jj, sigma, ct)
    ii, jj = cuda_gen.check_pairs(X, Y, ii, jj, "rbf_dd_vjp")
    P, M, N, D = ii.shape[0], X.shape[1], Y.shape[1], X.shape[2]
    if (ct.shape != (P, max(M - 1, 0), max(N - 1, 0)) or ct.dtype != X.dtype
            or ct.device != X.device or not ct.is_contiguous()):
        raise ValueError(f"rbf_dd_vjp: ct must be a contiguous "
                         f"{(P, M - 1, N - 1)} tensor of the paths' dtype "
                         "and device")
    if _THREADS * (D + 1) * X.element_size() > _build.SMEM_BYTES:
        raise ValueError(f"rbf_dd_vjp: dim {D} needs more shared memory "
                         f"than a block has ({_build.SMEM_BYTES} bytes)")
    sig = _sigma(sigma, X)
    if P == 0 or M < 2 or N < 2:
        # no pairs, or no increments: every gradient is 0
        return X.new_zeros(()), torch.zeros_like(X), torch.zeros_like(Y)
    dx = torch.empty(P, M, D, dtype=X.dtype, device=X.device)
    dy = torch.empty(P, N, D, dtype=X.dtype, device=X.device)
    esum = torch.empty(P, -(-M // _THREADS), dtype=X.dtype, device=X.device)
    _build.launch("rbf_dd_vjp", _FNS, COUNTS, X, X.data_ptr(), Y.data_ptr(),
                  ii.data_ptr(), jj.data_ptr(), ct.data_ptr(), dx.data_ptr(),
                  dy.data_ptr(), esum.data_ptr(), P, M, N, D, float(sig))
    dX = torch.zeros_like(X).index_add_(0, ii, dx)
    dY = torch.zeros_like(Y).index_add_(0, jj, dy)
    return torch.sum(esum) / (sig * sig), dX, dY
