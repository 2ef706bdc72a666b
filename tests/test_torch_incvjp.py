"""The plain version of K4 (``ops.incvjp.rbf_dd_vjp_plain``) against
``sigkernel_tpu.ops.df_prep.rbf_dd_vjp(..., gram=False)`` on the same numpy
inputs, and its CPU route through the wrapper. float64 within 1e-12 of
max |grad| (the two differ only in summation order); float32 within 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigkernel_tpu.ops import df_prep

from sigkernel_tpu_torch.ops import incvjp

from conftest import make_paths

BARS = {torch.float64: 1e-12, torch.float32: 1e-5}


def _jax(X, Y, ii, jj, sigma, ct):
    ds, dx, dy = df_prep.rbf_dd_vjp(jnp.asarray(X[ii]), jnp.asarray(Y[jj]),
                                    sigma, jnp.asarray(ct), False)
    dX = np.zeros_like(X)
    dY = np.zeros_like(Y)
    np.add.at(dX, ii, np.asarray(dx))
    np.add.at(dY, jj, np.asarray(dy))
    return float(ds), dX, dY


def _check(got, want, bar):
    for g, w in zip(got, want):
        g = np.asarray(g.double().numpy())
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= bar * np.abs(w).max()


@pytest.mark.parametrize("M,N,D", [(7, 11, 2), (11, 7, 3), (2, 5, 1)])
@pytest.mark.parametrize("indices", ["identity", "repeated"])
def test_plain_vjp_matches_jax(rng, M, N, D, indices):
    X = make_paths(rng, 3, M, D, scale=0.6)
    Y = make_paths(rng, 4, N, D, scale=0.6)
    if indices == "identity":
        ii = jj = np.arange(3)
    else:
        ii = np.array([0, 2, 1, 2, 0, 1])
        jj = np.array([3, 0, 1, 3, 3, 2])
    ct = rng.normal(size=(ii.shape[0], M - 1, N - 1))
    want = _jax(X, Y, ii, jj, 0.7, ct)
    for dtype, bar in BARS.items():
        t = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
        for fn in (incvjp.rbf_dd_vjp, incvjp.rbf_dd_vjp_plain):
            got = fn(t(X), t(Y), torch.tensor(ii), torch.tensor(jj), 0.7,
                     t(ct))
            assert all(g.dtype == dtype for g in got)
            _check(got, want, bar)


def test_cpu_tensors_take_the_plain_version(rng):
    X = torch.tensor(make_paths(rng, 2, 5, 2))
    ii = torch.arange(2)
    ct = torch.ones(2, 4, 4, dtype=X.dtype)
    before = dict(incvjp.COUNTS)
    incvjp.rbf_dd_vjp(X, X, ii, ii, 1.0, ct)
    assert incvjp.COUNTS["plain"] == before["plain"] + 1
    assert incvjp.COUNTS["float64"] == before["float64"]


def test_no_increments_give_zero_gradients(rng):
    X = torch.tensor(make_paths(rng, 2, 1, 2))
    Y = torch.tensor(make_paths(rng, 2, 6, 2))
    ii = torch.arange(2)
    ds, dX, dY = incvjp.rbf_dd_vjp(X, Y, ii, ii, 0.5,
                                   torch.zeros(2, 0, 5, dtype=X.dtype))
    assert float(ds) == 0.0
    assert not dX.any() and not dY.any()
