"""The Linear kernel's grids and their VJP on the ``inc`` family's gradient
route (``sigkernel._GridPairs``, whose backward ``_LinearGen`` inherits),
on CPU tensors, steered there as on the card
(``test_torch_ckpt.tier_on_cpu``).

For exactly ``LinearKernel`` each chunk's base increment grid comes from
K10's plain version (``cuda_lgen.linear_gen_increments_plain``) in the
forward and again in the backward, and its cotangent reaches the scaled
increments by K11's (``cuda_lgen.linear_dd_vjp_plain``), then the paths and
``scale`` by ``cuda_lgen.scaled_increments_vjp``, with no autograd.

- K10's plain version equals ``pair_increments`` of the gathered scaled
  increments bit for bit (K6's op order), and
  ``double_difference(LinearKernel.batch_kernel)`` within 1e-13 of max
  |dd| in float64 (the Gram sums in another order).
- K11's plain version and the increments' VJP equal ``torch.autograd``
  through that Gram grid within 1e-13 of max |grad| in float64.
- ``sig_gram_lincomb(sym=True)`` and ``sig_scoring_rule``: values and
  gradients in X and ``scale`` on the ``ckpt`` and ``full`` tiers, which
  agree bit for bit, against the grid built in PyTorch and differentiated
  by autograd (``_torch_grid_backward``, the route these kernels replace:
  1e-12 of max |grad| in float64, 1e-5 in float32, whose rounding differs
  from the oracle's in the grid's build) and against ``jax.grad`` of the
  JAX scan tier (``test_torch_ckpt.GRAD_BAR``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigkernel_tpu as sk

import sigkernel_tpu_torch as skt
from sigkernel_tpu_torch import sigkernel as sigmod
from sigkernel_tpu_torch.ops import cuda_lgen, routes
from sigkernel_tpu_torch.utils import double_difference

from conftest import make_paths
from test_torch_adjoint import _close
from test_torch_ckpt import GRAD_BAR, tier_on_cpu  # noqa: F401

_SCALE = 0.8
# the kernels against the PyTorch grid with autograd, max |err| / max |ref|
ORACLE_BAR = {torch.float64: 1e-12, torch.float32: 1e-5}


def _pairs_inputs(dtype, M, N, D, P=7, seed=5):
    rng = np.random.default_rng(seed)
    X = torch.tensor(make_paths(rng, 3, M, D, scale=0.6), dtype=dtype)
    Y = torch.tensor(make_paths(rng, 4, N, D, scale=0.6), dtype=dtype)
    ii = torch.tensor(rng.integers(0, 3, P))
    jj = torch.tensor(rng.integers(0, 4, P))
    return X, Y, ii, jj


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("M,N,D", [(9, 13, 3), (13, 9, 1), (7, 11, 9),
                                   (2, 6, 3), (6, 2, 9), (1, 5, 1)])
def test_k10_plain_is_pair_increments(dtype, M, N, D):
    """K10's wrapper on CPU tensors is its plain version: the gathered
    pairs' ``pair_increments`` of the scaled increments, bit for bit (K6's
    op order), in the pairs' own frame ``(P, M-1, N-1)``."""
    X, Y, ii, jj = _pairs_inputs(dtype, M, N, D)
    a = cuda_lgen.scaled_increments(X, _SCALE)
    b = cuda_lgen.scaled_increments(Y, _SCALE)
    # K6's op order: the coordinates' products added in order, from d = 0
    want = a[ii, :, None, 0] * b[jj, None, :, 0]
    for d in range(1, D):
        want = want + a[ii, :, None, d] * b[jj, None, :, d]
    before = cuda_lgen.INCREMENT_COUNTS["plain"]
    got = cuda_lgen.linear_gen_increments(a, b, ii, jj)
    assert cuda_lgen.INCREMENT_COUNTS["plain"] == before + 1
    assert got.dtype == dtype and got.shape == (7, M - 1, N - 1)
    assert torch.equal(got, want)


@pytest.mark.parametrize("M,N,D", [(9, 13, 3), (40, 30, 5), (12, 17, 9)])
def test_k10_plain_is_the_double_difference_of_the_gram(M, N, D):
    """The same grids as ``double_difference(LinearKernel.batch_kernel)``
    in float64, to the rounding of their other op order."""
    X, Y, ii, jj = _pairs_inputs(torch.float64, M, N, D)
    want = double_difference(skt.LinearKernel(_SCALE).batch_kernel(X[ii],
                                                                   Y[jj]))
    got = cuda_lgen.linear_gen_increments_plain(
        cuda_lgen.scaled_increments(X, _SCALE),
        cuda_lgen.scaled_increments(Y, _SCALE), ii, jj)
    assert (got - want).abs().max() <= 1e-13 * want.abs().max()


@pytest.mark.parametrize("M,N,D", [(9, 13, 3), (13, 9, 1), (12, 17, 9)])
def test_k11_plain_matches_autograd_of_the_grid(M, N, D):
    """K11's plain version is the VJP of the pairs' grids to their
    increments, and with the scatter and ``scaled_increments_vjp`` the VJP
    of ``double_difference(LinearKernel.batch_kernel)`` to the paths and
    ``scale``, within 1e-13 of max |grad|."""
    X, Y, ii, jj = _pairs_inputs(torch.float64, M, N, D)
    ct = torch.randn(7, M - 1, N - 1, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(M + N + D))
    a = cuda_lgen.scaled_increments(X, _SCALE)
    b = cuda_lgen.scaled_increments(Y, _SCALE)
    before = cuda_lgen.VJP_COUNTS["plain"]
    U, V = cuda_lgen.linear_dd_vjp(a, b, ii, jj, ct)
    assert cuda_lgen.VJP_COUNTS["plain"] == before + 1
    ag, bg = a[ii].requires_grad_(), b[jj].requires_grad_()
    wu, wv = torch.autograd.grad(cuda_lgen.pair_increments(ag, bg), [ag, bg],
                                 ct)
    assert _rel(U, wu) <= 1e-13 and _rel(V, wv) <= 1e-13
    # the whole chain against autograd through the Gram's grid
    dX, dsx = cuda_lgen.scaled_increments_vjp(
        X, _SCALE, torch.zeros_like(a).index_add_(0, ii, U))
    dY, dsy = cuda_lgen.scaled_increments_vjp(
        Y, _SCALE, torch.zeros_like(b).index_add_(0, jj, V))
    xg, yg = X.clone().requires_grad_(), Y.clone().requires_grad_()
    s = torch.tensor(_SCALE, dtype=torch.float64, requires_grad=True)
    grid = double_difference(skt.LinearKernel(s).batch_kernel(xg[ii],
                                                              yg[jj]))
    wx, wy, ws = torch.autograd.grad(grid, [xg, yg, s], ct)
    assert _rel(dX, wx) <= 1e-13 and _rel(dY, wy) <= 1e-13
    assert abs(float(dsx + dsy - ws)) <= 1e-13 * abs(float(ws))


def _counts():
    return (cuda_lgen.INCREMENT_COUNTS["plain"],
            cuda_lgen.VJP_COUNTS["plain"])


@pytest.fixture
def oracle(monkeypatch):
    """Turn ``_GridPairs``' Linear backward into the autograd route it
    replaces, ``_torch_grid_backward``: the grid built in PyTorch."""
    def autograd_route(X, Y, ii, jj, scale, g, bwd_dtype, dyadic_order,
                       naive):
        s = scale.detach().clone().requires_grad_()
        dX, dY, ds = sigmod._torch_grid_backward(
            skt.LinearKernel(s), X, Y, ii, jj, g, [s], bwd_dtype,
            dyadic_order, naive)
        return ds, dX, dY

    return lambda: monkeypatch.setattr(sigmod, "_linear_grid_backward",
                                       autograd_route)


def _estimator(name, module, kernel, x, other, **kw):
    if name == "lincomb":
        return module.sig_gram_lincomb(kernel, x, x, other, sym=True,
                                       dyadic_order=1, pair_chunk=4, **kw)
    return module.sig_scoring_rule(kernel, x, other, dyadic_order=1, **kw)


def _inputs(rng, name):
    X = make_paths(rng, 3, 6, 2, scale=0.6)
    if name == "lincomb":
        W = rng.normal(size=(3, 3))
        return X, W
    return X, make_paths(rng, 1, 7, 2, scale=0.6)


def _jax(name, X, other, scale):
    def f(x, s):
        return _estimator(name, sk, sk.LinearKernel(s), x, jnp.asarray(other),
                          solver="scan")

    return jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(X),
                                                 jnp.asarray(scale))


def _run(name, X, other, dtype, scale=_SCALE, scale_grad=True, **kw):
    x = torch.tensor(X, dtype=dtype, requires_grad=True)
    s = torch.tensor(scale, dtype=dtype, requires_grad=scale_grad)
    v = _estimator(name, skt, skt.LinearKernel(s), x,
                   torch.tensor(other, dtype=dtype), **kw)
    v.backward()
    return v.detach(), x.grad, s.grad


@pytest.mark.parametrize("dtype,grade", [(torch.float64, "auto"),
                                         (torch.float32, "auto"),
                                         (torch.float64, "f32")])
@pytest.mark.parametrize("name", ["lincomb", "scoring"])
def test_linear_gradient_takes_k10_and_k11(rng, tier_on_cpu, oracle, name,
                                           dtype, grade):
    """``LinearKernel``'s value and gradients in X and ``scale`` through
    K10 and K11 (their plain counts rise: a K10 grid a chunk in each pass,
    a K11 call a chunk in the backward) on both tiers, equal to each other,
    to the autograd route and to JAX; the ``f32`` grade runs them on
    float32 increments, within the float32 bars."""
    X, other = _inputs(rng, name)
    want_v, want_g = _jax(name, X, other, _SCALE)
    low = torch.float32 if grade == "f32" else dtype
    runs = {}
    for tier, pairs in (("ckpt", 1 << 40), ("full", 0)):
        tier_on_cpu(pairs)
        assert routes.resolve_inc_tier((10, 12), 8, backward=True) == tier
        k10, k11 = _counts()
        runs[tier] = _run(name, X, other, dtype, grad_solver=grade)
        got10, got11 = _counts()
        assert got10 - k10 == 2 * (got11 - k11) > 0
    for got, full in zip(runs["ckpt"], runs["full"]):
        assert torch.equal(got, full)
    v, dX, ds = runs["ckpt"]
    assert dX.dtype == ds.dtype == dtype
    oracle()
    before = _counts()
    ov, odX, ods = _run(name, X, other, dtype, grad_solver=grade)
    assert _counts()[1] == before[1]  # the autograd route runs no K11
    assert torch.equal(v, ov)
    assert _rel(dX, odX) <= ORACLE_BAR[low]
    assert abs(float(ds - ods)) <= ORACLE_BAR[low] * abs(float(ods))
    _close(v, want_v, GRAD_BAR[dtype])
    _close(dX, want_g[0], GRAD_BAR[low])
    _close(ds, want_g[1], GRAD_BAR[low])


@pytest.mark.parametrize("name", ["lincomb", "scoring"])
def test_scale_zero_and_scale_without_gradient(rng, tier_on_cpu, oracle,
                                               name):
    """``scale = 0`` gives finite gradients equal to the autograd route's
    (no division by ``scale``); a ``scale`` that requires no gradient
    gets none, and X's gradient is the same as with one."""
    tier_on_cpu(0)
    X, other = _inputs(rng, name)
    zero = _run(name, X, other, torch.float64, scale=0.0)
    assert all(bool(torch.isfinite(t).all()) for t in zero)
    plain = _run(name, X, other, torch.float64, scale_grad=False)
    assert plain[2] is None
    full = _run(name, X, other, torch.float64)
    assert torch.equal(plain[1], full[1])
    oracle()
    want = _run(name, X, other, torch.float64, scale=0.0)
    assert torch.equal(zero[0], want[0])
    assert float((zero[1] - want[1]).abs().max()) <= 1e-12 * float(
        want[1].abs().max())
    assert abs(float(zero[2] - want[2])) <= 1e-12 * max(
        abs(float(want[2])), float(want[1].abs().max()))
