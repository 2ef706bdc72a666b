"""The ``inc`` family's gradient route (``sigkernel._GridPairs``) on CPU
tensors, steered there as on the card (``test_torch_ckpt.tier_on_cpu``).

For exactly ``RBFKernel`` each chunk's base increment grid comes from K9's
plain version (``cuda_gen.rbf_gen_increments_plain``) in the forward and
again in the backward, and its cotangent reaches the paths and sigma by
K4's (``incvjp.rbf_dd_vjp_plain``), with no autograd. ``RBF_ID_Kernel`` (an
``RBFKernel`` subclass) keeps the grid built in PyTorch and autograd
through it; ``LinearKernel`` takes neither K9 nor K4 but its own K10 and
K11 (``tests/test_torch_linear_grid.py``). Values and gradients in X and
sigma (``scale``)
against ``jax.grad`` of the JAX scan tier at dyadic order 2 within
``test_torch_ckpt.GRAD_BAR``, on the ``ckpt`` tier (K2-sparse -> K8) and
the ``full`` tier (K2-stack -> K3<inc>), which agree bit for bit.

K9's plain version equals ``gen_increments`` of the gathered pairs bit for
bit, in chunks of pairs too, and ``double_difference(batch_kernel)`` within
1e-13 of max |dd| in float64 (the two sum in other orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigkernel_tpu as sk

import sigkernel_tpu_torch as skt
from sigkernel_tpu_torch.ops import cuda_gen, cuda_lgen, incvjp, routes
from sigkernel_tpu_torch.utils import double_difference

from conftest import make_paths
from test_torch_adjoint import _close
from test_torch_ckpt import GRAD_BAR, tier_on_cpu  # noqa: F401

_SIGMA = 0.7


def _estimator(name, module, kernel, x, other, **kw):
    fn = {"scoring": module.sig_scoring_rule, "mmd": module.sig_mmd}[name]
    return fn(kernel, x, other, dyadic_order=2, **kw)


def _jax(name, make, X, other):
    """Value and ``(dX, d sigma)`` of the JAX scan tier."""
    def f(x, s):
        return _estimator(name, sk, make(sk, s), x, jnp.asarray(other),
                          solver="scan")

    return jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(X),
                                                 jnp.asarray(_SIGMA))


def _inputs(rng, name):
    X = make_paths(rng, 3, 6, 2, scale=0.6)
    other = make_paths(rng, 1 if name == "scoring" else 2, 7, 2, scale=0.6)
    return X, other


def _run(name, make, X, other, dtype, **kw):
    x = torch.tensor(X, dtype=dtype, requires_grad=True)
    sigma = torch.tensor(_SIGMA, dtype=dtype, requires_grad=True)
    v = _estimator(name, skt, make(skt, sigma), x,
                   torch.tensor(other, dtype=dtype), **kw)
    v.backward()
    return v.detach(), x.grad, sigma.grad


def _counts():
    return (cuda_gen.INCREMENT_COUNTS["plain"], incvjp.COUNTS["plain"])


_RBF = lambda m, s: m.RBFKernel(s)  # noqa: E731


@pytest.mark.parametrize("dtype,grade", [(torch.float64, "auto"),
                                         (torch.float32, "auto"),
                                         (torch.float64, "f32")])
@pytest.mark.parametrize("name", ["scoring", "mmd"])
def test_rbf_gradient_takes_k9_and_k4_and_matches_jax(rng, tier_on_cpu, name,
                                                      dtype, grade):
    """``RBFKernel``'s value and gradients in X and sigma through K9 and K4
    (their plain counts rise, forward and backward) on both tiers, equal to
    each other and to JAX; the ``f32`` grade runs them on float32 paths,
    within the float32 bar."""
    X, other = _inputs(rng, name)
    want_v, want_g = _jax(name, _RBF, X, other)
    bar = GRAD_BAR[torch.float32 if grade == "f32" else dtype]
    runs = {}
    for tier, pairs in (("ckpt", 1 << 40), ("full", 0)):
        tier_on_cpu(pairs)
        assert routes.resolve_inc_tier((20, 24), 8, backward=True) == tier
        k9, k4 = _counts()
        runs[tier] = _run(name, _RBF, X, other, dtype, grad_solver=grade)
        # a K9 grid a chunk in the forward and in the backward, one K4 call
        # a chunk in the backward
        got9, got4 = _counts()
        assert got9 - k9 == 2 * (got4 - k4) > 0
    for got, full in zip(runs["ckpt"], runs["full"]):
        assert torch.equal(got, full)
    v, dX, ds = runs["ckpt"]
    assert dX.dtype == ds.dtype == dtype
    _close(v, want_v, GRAD_BAR[dtype])
    _close(dX, want_g[0], bar)
    _close(ds, want_g[1], bar)


@pytest.mark.parametrize("kernel", ["rbf_id", "linear"])
@pytest.mark.parametrize("tier", ["ckpt", "full"])
def test_other_kernels_keep_the_autograd_grid(rng, tier_on_cpu, tier,
                                              kernel):
    """An ``RBFKernel`` subclass and ``LinearKernel`` take neither K9 nor K4,
    and still match JAX: the subclass's grids are built in PyTorch and
    differentiated by autograd; ``LinearKernel``'s come from K10 and their
    cotangent goes by K11 (their plain counts rise)."""
    make = {"rbf_id": lambda m, s: m.RBF_ID_Kernel(s),
            "linear": lambda m, s: m.LinearKernel(s)}[kernel]
    tier_on_cpu(1 << 40 if tier == "ckpt" else 0)
    X, y = _inputs(rng, "scoring")
    want_v, want_g = _jax("scoring", make, X, y)
    before = _counts()
    linear = (cuda_lgen.INCREMENT_COUNTS["plain"],
              cuda_lgen.VJP_COUNTS["plain"])
    v, dX, ds = _run("scoring", make, X, y, torch.float64)
    assert _counts() == before
    k10 = cuda_lgen.INCREMENT_COUNTS["plain"] - linear[0]
    k11 = cuda_lgen.VJP_COUNTS["plain"] - linear[1]
    if kernel == "linear":
        assert k10 == 2 * k11 > 0
    _close(v, want_v, GRAD_BAR[torch.float64])
    _close(dX, want_g[0], GRAD_BAR[torch.float64])
    _close(ds, want_g[1], GRAD_BAR[torch.float64])


def _pairs_inputs(dtype, M, N, D, P=7, seed=3):
    rng = np.random.default_rng(seed)
    X = torch.tensor(make_paths(rng, 3, M, D, scale=0.6), dtype=dtype)
    Y = torch.tensor(make_paths(rng, 4, N, D, scale=0.6), dtype=dtype)
    ii = torch.tensor(rng.integers(0, 3, P))
    jj = torch.tensor(rng.integers(0, 4, P))
    return X, Y, ii, jj


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("M,N,D", [(9, 13, 3), (13, 9, 1), (2, 6, 5),
                                   (6, 2, 10), (1, 5, 2)])
def test_k9_plain_is_gen_increments(monkeypatch, dtype, M, N, D):
    """K9's wrapper on CPU tensors is its plain version: ``gen_increments``
    of the gathered pairs, bit for bit, also in chunks of two pairs, in
    the pairs' own frame ``(P, M-1, N-1)``."""
    X, Y, ii, jj = _pairs_inputs(dtype, M, N, D)
    want = cuda_gen.gen_increments(X[ii], Y[jj], _SIGMA)
    before = cuda_gen.INCREMENT_COUNTS["plain"]
    got = cuda_gen.rbf_gen_increments(X, Y, ii, jj, _SIGMA)
    assert cuda_gen.INCREMENT_COUNTS["plain"] == before + 1
    assert got.dtype == dtype and got.shape == (7, M - 1, N - 1)
    assert torch.equal(got, want)
    monkeypatch.setattr(cuda_gen, "plain_chunk", lambda *a: 2)
    assert torch.equal(cuda_gen.rbf_gen_increments_plain(
        X, Y, ii, jj, torch.tensor(_SIGMA, dtype=dtype)), want)


@pytest.mark.parametrize("M,N,D", [(9, 13, 3), (40, 30, 5)])
def test_k9_plain_is_the_double_difference_of_the_gram(M, N, D):
    """The same grids as ``double_difference(RBFKernel.batch_kernel)`` in
    float64, to the rounding of their other op order."""
    X, Y, ii, jj = _pairs_inputs(torch.float64, M, N, D)
    want = double_difference(skt.RBFKernel(_SIGMA).batch_kernel(X[ii], Y[jj]))
    got = cuda_gen.rbf_gen_increments_plain(X, Y, ii, jj, _SIGMA)
    assert (got - want).abs().max() <= 1e-13 * want.abs().max()
