"""The K1 (RBF-generation wavefront) wrapper's plain version and CPU route
against the JAX package's ``sig_kernel`` with ``RBFKernel`` on the same numpy
paths. On the CPU the JAX public functions take the f64 scan tier, the plain
reference its own tests hold the Pallas kernels to."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import sigkernel_tpu as sk
from sigkernel_tpu.utils import double_difference as jdd

import sigkernel_tpu_torch as skt
from sigkernel_tpu_torch.ops import cuda_gen
from sigkernel_tpu_torch.utils import double_difference

from conftest import make_paths

# f64: the port's parity bar; f32 port against JAX f64
RTOL = {torch.float64: 1e-10, torch.float32: 1e-4}


def _jax_pairs(X, Y, ii, jj, sigma, dyadic, naive):
    return np.asarray(sk.sig_kernel(sk.RBFKernel(sigma), jnp.asarray(X[ii]),
                                    jnp.asarray(Y[jj]), dyadic_order=dyadic,
                                    naive=naive))


@pytest.mark.parametrize("naive", [False, True])
@pytest.mark.parametrize("dyadic", [0, 1, 2])
@pytest.mark.parametrize("M,N,D", [(10, 20, 2), (20, 10, 3)])
def test_gen_plain_per_pair_matches_jax(rng, naive, dyadic, M, N, D):
    X = make_paths(rng, 4, M, D, scale=0.6)
    Y = make_paths(rng, 4, N, D, scale=0.6)
    ii = np.arange(4)
    want = _jax_pairs(X, Y, ii, ii, 0.5, dyadic, naive)
    for dtype, rtol in RTOL.items():
        t = torch.arange(4)
        got = cuda_gen.rbf_gen_solve_final_plain(
            torch.tensor(X, dtype=dtype), torch.tensor(Y, dtype=dtype), t, t,
            0.5, dyadic, naive)
        assert got.dtype == dtype and got.shape == (4,)
        np.testing.assert_allclose(got.double().numpy(), want, rtol=rtol)


@pytest.mark.parametrize("dyadic", [0, 1, 2])
def test_gen_plain_over_index_lists_matches_jax(rng, dyadic):
    X = make_paths(rng, 3, 12, 3, scale=0.6)
    Y = make_paths(rng, 5, 9, 3, scale=0.6)
    ii = np.array([0, 2, 1, 2, 0, 1, 1])
    jj = np.array([4, 0, 1, 3, 3, 2, 4])
    want = _jax_pairs(X, Y, ii, jj, 0.8, dyadic, False)
    for dtype, rtol in RTOL.items():
        got = cuda_gen.rbf_gen_solve_final_plain(
            torch.tensor(X, dtype=dtype), torch.tensor(Y, dtype=dtype),
            torch.tensor(ii), torch.tensor(jj), 0.8, dyadic)
        np.testing.assert_allclose(got.double().numpy(), want, rtol=rtol)


def test_gen_increments_equal_the_double_difference(rng):
    X = torch.tensor(make_paths(rng, 3, 7, 3))
    Y = torch.tensor(make_paths(rng, 3, 11, 3))
    got = cuda_gen.gen_increments(X, Y, 0.7)
    want = double_difference(skt.RBFKernel(0.7).batch_kernel(X, Y))
    assert got.shape == (3, 6, 10)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-15)
    np.testing.assert_allclose(
        got.numpy(),
        np.asarray(jdd(sk.RBFKernel(0.7).batch_kernel(X.numpy(),
                                                      Y.numpy()))),
        rtol=0, atol=1e-15)


def test_gen_wrapper_cpu_route_runs_the_plain_version(rng):
    X = torch.tensor(make_paths(rng, 3, 8, 2))
    Y = torch.tensor(make_paths(rng, 2, 6, 2))
    ii, jj = torch.tensor([0, 1, 2, 2]), torch.tensor([1, 0, 0, 1])
    counts = dict(cuda_gen.COUNTS)
    got = cuda_gen.rbf_gen_solve_final(X, Y, ii, jj, 0.5, 1, True)
    want = cuda_gen.rbf_gen_solve_final_plain(X, Y, ii, jj, 0.5, 1, True)
    assert torch.equal(got, want)
    assert cuda_gen.COUNTS["float32"] == counts["float32"]
    assert cuda_gen.COUNTS["float64"] == counts["float64"]
    assert cuda_gen.COUNTS["plain"] == counts["plain"] + 2


def test_gen_plain_degenerate_inputs(rng):
    X = torch.tensor(make_paths(rng, 2, 1, 2))      # length-1 paths
    Y = torch.tensor(make_paths(rng, 2, 6, 2))
    ii = torch.arange(2)
    for dyadic in (0, 2):
        assert torch.equal(
            cuda_gen.rbf_gen_solve_final(X, Y, ii, ii, 1.0, dyadic),
            torch.ones(2, dtype=torch.float64))
    empty = torch.zeros(0, dtype=torch.int64)
    out = cuda_gen.rbf_gen_solve_final(Y, Y, empty, empty, 1.0)
    assert out.shape == (0,) and out.dtype == torch.float64


def test_gen_wrapper_rejects_other_devices():
    X = torch.empty(2, 5, 2, device="meta")
    ii = torch.arange(2, device="meta")
    with pytest.raises(ValueError, match="meta"):
        cuda_gen.rbf_gen_solve_final(X, X, ii, ii, 1.0)


# ---------------------------------------------------------------------------
# The link to the TPU kernels K1 replaces: the port's plain version against
# the Pallas kernels in interpret mode (slow: every step simulated).
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("dyadic", [0, 1, 2])
def test_gen_plain_matches_pallas_interpret(rng, dyadic):
    from jax.experimental.pallas import tpu as pltpu
    from sigkernel_tpu.ops import pallas_df64, pallas_fused, pallas_gen32

    X = make_paths(rng, 3, 8, 3, scale=0.5)
    Y = make_paths(rng, 3, 10, 3, scale=0.5)
    x32, y32 = jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        want32 = [np.asarray(pallas_gen32.solve_final_f32_gen(
            x32, y32, 0.9, dyadic_order=dyadic))]
        if dyadic == 0:
            want32.append(np.asarray(pallas_fused.solve_final_rbf(
                x32, y32, 0.9)))
        else:
            want32.append(np.asarray(pallas_fused.solve_final_rbf_dyadic(
                x32, y32, 0.9, dyadic)))
        want64 = np.asarray(pallas_df64.solve_final_df_gen(
            jnp.asarray(X), jnp.asarray(Y), 0.9, dyadic_order=dyadic))
    t = torch.arange(3)
    got32 = cuda_gen.rbf_gen_solve_final_plain(
        torch.tensor(X, dtype=torch.float32),
        torch.tensor(Y, dtype=torch.float32), t, t, 0.9, dyadic).numpy()
    got64 = cuda_gen.rbf_gen_solve_final_plain(
        torch.tensor(X), torch.tensor(Y), t, t, 0.9, dyadic).numpy()
    for w in want32:
        np.testing.assert_allclose(got32, w, rtol=2e-5)
    # the DF generation tier is f64-grade, not f64-exact: it is held to the
    # error-model bound of tests/test_pallas_df64.py::gen_tol (its hi-only
    # u^2/12 chain perturbs each update by <= 3 u^2 2^-23; 4x headroom)
    f = 2 ** dyadic
    u = np.abs(np.asarray(jdd(sk.RBFKernel(0.9).batch_kernel(X, Y)))).max()
    u /= f * f
    atol = (4.0 * ((7 + 9) * f - 1) * 3.0 * u * u * 2.0 ** -23
            + 1e-11 * np.abs(want64).max())
    np.testing.assert_allclose(got64, want64, rtol=0, atol=atol)
