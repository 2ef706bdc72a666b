"""The X-X term of a Linear signature-MMD loss on the ``lgen`` route:
``sig_gram_lincomb(LinearKernel(scale), X, X, W, sym=True)`` with the
unbiased MMD^2's weights ``W = (1 - I) / (n (n - 1))``, its value and its
gradients in ``X`` (both slots) and ``scale``, against the benchmark's plain
reference (``bench_torch/reference.lincomb_grads`` with
``static_kernels/LinearKernel.py``), which sums all ``n^2`` ordered pairs
and shares no code with the port. The route is steered onto ``lgen`` on CPU
tensors by patching ``routes.resolve_family``, as
``test_torch_linear_gen.py`` does; the wrappers then take their plain
versions (K6's, K2-stack's and K3<inc>'s).

Bars, in float64 (the same call in float32 misses them:
:func:`test_float32_fails_the_bars`):

- the value within 1e-10 relative: the two sweeps run the same order-2
  scheme on the same increments in another order of operations, a few
  hundred steps of rounding at 1e-16 each, so 1e-10 leaves five decades;
- ``dX`` and ``dscale`` within 1e-9 of max |grad|: the port's adjoint
  collapses the products on the base grid and autograd maps them through
  the Linear Gram, the reference by its hand-written VJP, summing over the
  grid's cells in another order; float32's ~1e-7 fails it by decades.
"""
import pytest
import torch

import sigkernel_tpu_torch as skt
from bench_torch import reference as ref
from sigkernel_tpu_torch.ops import cuda_lgen, cuda_solver, routes

LINEAR = ref.static_kernel("LinearKernel")
VALUE_BAR = 1e-10
GRAD_BAR = 1e-9
SCALE = 0.8


@pytest.fixture
def lgen_on_cpu(monkeypatch):
    """Steer exactly-``LinearKernel`` tiles on CPU tensors onto ``lgen``."""
    orig = routes.resolve_family

    def steered(static_kernel, device_type, solver, **gates):
        if type(static_kernel) is skt.LinearKernel and solver != "scan":
            return "lgen"
        return orig(static_kernel, device_type, solver, **gates)

    monkeypatch.setattr(routes, "resolve_family", steered)


def _paths(n, length, dim, seed):
    g = torch.Generator().manual_seed(seed)
    z = torch.randn(n, length, dim, generator=g, dtype=torch.float64)
    return z.cumsum(1) / length ** 0.5


def _weights(n, dtype):
    return (1.0 - torch.eye(n, dtype=dtype)) / (n * (n - 1.0))


def _program(X, dyadic, dtype, chunk):
    """The port's value, dX and dscale in ``dtype``."""
    x = X.to(dtype, copy=True).requires_grad_()
    scale = torch.tensor(SCALE, dtype=dtype, requires_grad=True)
    S = skt.sig_gram_lincomb(skt.LinearKernel(scale), x, x,
                             _weights(X.shape[0], dtype), sym=True,
                             dyadic_order=dyadic, pair_chunk=chunk)
    S.backward()
    return S.detach(), x.grad, scale.grad


def _reference(X, dyadic):
    S, dX, dY, dp = ref.lincomb_grads(
        X, X, _weights(X.shape[0], X.dtype),
        LINEAR.Kernel(X.new_tensor(SCALE)), 2 ** dyadic)
    return S, dX + dY, dp


def _errors(got, want):
    """Relative error of the value; errors of dX and dscale over max
    |grad|."""
    (v, dx, ds), (wv, wdx, wds) = got, want
    return (abs(float(v) - float(wv)) / abs(float(wv)),
            float((dx.double() - wdx).abs().max() / wdx.abs().max()),
            abs(float(ds) - float(wds)) / abs(float(wds)))


COUNTS = {"K6": cuda_lgen.COUNTS, "K2-stack": cuda_solver.STACK_COUNTS,
          "K3<inc>": cuda_solver.ADJOINT_COUNTS,
          "K2-sparse": cuda_solver.SPARSE_COUNTS,
          "K8": cuda_solver.CKPT_COUNTS}


@pytest.mark.parametrize("n,length,dyadic,chunk", [
    (4, 12, 0, 128), (5, 16, 1, 128), (5, 13, 1, 4)])
def test_sym_lincomb_matches_the_plain_reference(lgen_on_cpu, n, length,
                                                 dyadic, chunk):
    """Values and gradients on the ``lgen`` route, the triangle in one
    chunk and (``pair_chunk`` 4) in several; the backward takes the full
    tier (K2-stack, K3<inc>), never the sparse one."""
    X = _paths(n, length, 3, seed=1000 * n + length + dyadic)
    before = {k: c["plain"] for k, c in COUNTS.items()}
    got = _program(X, dyadic, torch.float64, chunk)
    ran = {k: c["plain"] - before[k] for k, c in COUNTS.items()}
    pairs = n * (n + 1) // 2
    chunks = -(-pairs // chunk)
    assert ran["K6"] == chunks
    assert ran["K2-stack"] == ran["K3<inc>"] == chunks
    assert ran["K2-sparse"] == ran["K8"] == 0
    value, dx, dscale = _errors(got, _reference(X, dyadic))
    assert value <= VALUE_BAR
    assert dx <= GRAD_BAR
    assert dscale <= GRAD_BAR


def test_float32_fails_the_bars(lgen_on_cpu):
    """The bars tell float64 from the precision below it: the same call in
    float32 misses at least one."""
    X = _paths(5, 16, 3, seed=7)
    want = _reference(X, 1)
    sound = _errors(_program(X, 1, torch.float64, 128), want)
    low = _errors(_program(X, 1, torch.float32, 128), want)
    bars = (VALUE_BAR, GRAD_BAR, GRAD_BAR)
    assert all(e <= b for e, b in zip(sound, bars)), sound
    assert any(e > b for e, b in zip(low, bars)), low
