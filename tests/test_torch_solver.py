"""The port's plain solver, the K2 wrapper's CPU route and ``ops.solve``
against ``sigkernel_tpu.ops.scan_solver`` / ``ops.solve`` on the same
numpy increment grids."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import sigkernel_tpu as sk
from sigkernel_tpu.ops import scan_solver as jscan
from sigkernel_tpu.ops import solve as jsolve
from sigkernel_tpu.utils import double_difference as jdd

from sigkernel_tpu_torch.ops import cuda_solver, scan_solver
from sigkernel_tpu_torch.ops.solve import solve

from conftest import make_paths


def _inc(rng, batch, M, N, sigma=0.6):
    """An RBF increment grid (batch, M-1, N-1) as numpy f64."""
    X = make_paths(rng, batch, M, 2, scale=0.6)
    Y = make_paths(rng, batch, N, 2, scale=0.6)
    return np.asarray(jdd(sk.RBFKernel(sigma).batch_kernel(X, Y)))


@pytest.mark.parametrize("naive", [False, True])
@pytest.mark.parametrize("M,N", [(7, 10), (10, 7), (8, 8), (2, 9)])
def test_solve_final_matches_jax_scan(rng, naive, M, N):
    inc = _inc(rng, 3, M, N)
    got = scan_solver.solve_final(torch.tensor(inc), naive).numpy()
    want = np.asarray(jscan.solve_final(jnp.asarray(inc), naive=naive))
    np.testing.assert_allclose(got, want, rtol=1e-13)


@pytest.mark.parametrize("naive", [False, True])
def test_solve_grid_matches_jax_scan(rng, naive):
    inc = _inc(rng, 2, 6, 9)
    got = scan_solver.solve_grid(torch.tensor(inc), naive).numpy()
    want = np.asarray(jscan.solve_grid(jnp.asarray(inc), naive=naive))
    assert got.shape == want.shape == (2, 6, 9)
    np.testing.assert_allclose(got, want, rtol=1e-13)
    final = scan_solver.solve_final(torch.tensor(inc), naive).numpy()
    np.testing.assert_array_equal(got[:, -1, -1], final)


def test_solver_batch_dims_and_degenerate_grids(rng):
    inc = _inc(rng, 6, 5, 4).reshape(2, 3, 4, 3)
    got = scan_solver.solve_final(torch.tensor(inc))
    assert got.shape == (2, 3)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jscan.solve_final(jnp.asarray(inc))),
        rtol=1e-13)
    for shape in ((2, 0, 5), (2, 4, 0)):
        empty = torch.zeros(shape, dtype=torch.float64)
        assert torch.equal(scan_solver.solve_final(empty),
                           torch.ones(2, dtype=torch.float64))
        assert torch.equal(scan_solver.solve_grid(empty),
                           torch.ones(2, shape[1] + 1, shape[2] + 1,
                                      dtype=torch.float64))


@pytest.mark.parametrize("naive", [False, True])
@pytest.mark.parametrize("dyadic", [0, 1, 2])
def test_inc_wrapper_cpu_route_matches_jax(rng, naive, dyadic):
    inc = _inc(rng, 4, 8, 11)
    want = np.asarray(jsolve.solve(jnp.asarray(inc), naive=naive,
                                   dyadic_order=dyadic))
    counts = dict(cuda_solver.COUNTS)
    got64 = cuda_solver.inc_solve_final(torch.tensor(inc), dyadic, naive)
    got32 = cuda_solver.inc_solve_final(
        torch.tensor(inc, dtype=torch.float32), dyadic, naive)
    assert got64.dtype == torch.float64 and got32.dtype == torch.float32
    np.testing.assert_allclose(got64.numpy(), want, rtol=1e-10)
    np.testing.assert_allclose(got32.double().numpy(), want, rtol=1e-4)
    # the CPU route runs the plain version and launches nothing
    assert cuda_solver.COUNTS["float32"] == counts["float32"]
    assert cuda_solver.COUNTS["float64"] == counts["float64"]
    assert cuda_solver.COUNTS["plain"] == counts["plain"] + 2


def test_inc_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="device"):
        cuda_solver.inc_solve_final(torch.empty(2, 3, 3, device="meta"))


@pytest.mark.parametrize("dyadic", [0, 1])
def test_solve_flattens_batch_dims_and_routes(rng, dyadic):
    inc = _inc(rng, 6, 6, 9).reshape(3, 2, 5, 8)
    want = np.asarray(jsolve.solve(jnp.asarray(inc), dyadic_order=dyadic))
    for solver in ("auto", "scan"):
        got = solve(torch.tensor(inc), False, solver, dyadic)
        assert got.shape == (3, 2)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)
    ones = solve(torch.zeros(3, 0, 4, dtype=torch.float64))
    assert torch.equal(ones, torch.ones(3, dtype=torch.float64))
    with pytest.raises(ValueError, match="CUDA"):
        solve(torch.tensor(inc), solver="cuda")
    with pytest.raises(ValueError, match="'auto', 'scan', 'cuda'"):
        solve(torch.tensor(inc), solver="pallas")


# ---------------------------------------------------------------------------
# The link to the TPU kernels K2 replaces: the port's plain version against
# the Pallas kernels in interpret mode (slow: every step simulated).
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("dyadic", [0, 1])
def test_inc_plain_matches_pallas_interpret(rng, dyadic):
    from jax.experimental.pallas import tpu as pltpu
    from sigkernel_tpu.ops import pallas_df64, pallas_solver

    inc = _inc(rng, 3, 8, 10)
    with pltpu.force_tpu_interpret_mode():
        want32 = np.asarray(pallas_solver.solve_final(
            jnp.asarray(inc, jnp.float32), dyadic_order=dyadic))
        want64 = np.asarray(pallas_df64.solve_final(
            jnp.asarray(inc), dyadic_order=dyadic))
    got32 = cuda_solver.inc_solve_final_plain(
        torch.tensor(inc, dtype=torch.float32), dyadic).numpy()
    got64 = cuda_solver.inc_solve_final_plain(torch.tensor(inc),
                                              dyadic).numpy()
    np.testing.assert_allclose(got32, want32, rtol=1e-5)
    np.testing.assert_allclose(got64, want64, rtol=1e-10)
