"""The adjoint's plain pieces against the JAX package on the same numpy
inputs: ``dd_transpose`` and the ``flip``/``tile`` shims, the stack layout,
the plain adjoint (``_grid_route_bwd``), the differentiable solve, and the
plain versions of K2-stack, K3<inc> and K3<gen>. The whole ``gen`` chain is
in ``test_torch_gen_chain.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigkernel_tpu as sk
from sigkernel_tpu.ops import solve as jsolve
from sigkernel_tpu.utils import dd_transpose as jdd_t
from sigkernel_tpu.utils import double_difference as jdd
from sigkernel_tpu.utils import flip as jflip
from sigkernel_tpu.utils import tile as jtile

from sigkernel_tpu_torch.ops import cuda_gen, cuda_solver, scan_solver
from sigkernel_tpu_torch.ops.solve import grid_route_bwd, solve
from sigkernel_tpu_torch.utils import dd_transpose, flip, tile

from conftest import make_paths

BAR = 1e-9  # float64, of max |grad|


def _inc(rng, batch, M, N, sigma=0.6):
    X = make_paths(rng, batch, M, 2, scale=0.6)
    Y = make_paths(rng, batch, N, 2, scale=0.6)
    return np.asarray(jdd(sk.RBFKernel(sigma).batch_kernel(X, Y)))


def _close(got, want, bar=BAR):
    want = np.asarray(want)
    got = got.detach().double().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= bar * max(np.abs(want).max(), 1e-300)


def test_dd_transpose_matches_jax(rng):
    ct = rng.normal(size=(3, 5, 7))
    np.testing.assert_array_equal(dd_transpose(torch.tensor(ct)).numpy(),
                                  np.asarray(jdd_t(jnp.asarray(ct))))


@pytest.mark.parametrize("dim", [0, 1, -1])
def test_flip_and_tile_match_jax(rng, dim):
    a = rng.normal(size=(2, 3, 4))
    np.testing.assert_array_equal(flip(torch.tensor(a), dim).numpy(),
                                  np.asarray(jflip(jnp.asarray(a), dim)))
    np.testing.assert_array_equal(tile(torch.tensor(a), dim, 3).numpy(),
                                  np.asarray(jtile(jnp.asarray(a), dim, 3)))


@pytest.mark.parametrize("M,N", [(6, 9), (9, 6), (7, 7)])
@pytest.mark.parametrize("dyadic", [0, 1, 2])
def test_stack_is_the_grid_relaid(rng, M, N, dyadic):
    """The plain K2-stack's values and stack are JAX's solve_with_grid
    re-laid; the stack maps back to the grid exactly."""
    inc = _inc(rng, 2, M, N)
    grid = np.asarray(jsolve.solve_with_grid(jnp.asarray(inc), solver="scan",
                                             dyadic_order=dyadic))
    vals, stack = cuda_solver.inc_solve_stack_plain(torch.tensor(inc),
                                                    dyadic)
    f = 2 ** dyadic
    MM, NN = (M - 1) * f, (N - 1) * f
    assert stack.shape == cuda_solver.stack_shape(2, MM, NN)
    np.testing.assert_allclose(vals.numpy(), grid[:, -1, -1], rtol=1e-13)
    back = scan_solver.stack_to_grid(stack, MM, NN)
    np.testing.assert_allclose(back.numpy(), grid, rtol=1e-13)
    assert torch.equal(scan_solver.grid_to_stack(back), stack)
    # cells outside the grid are 0; the boundary cells are 1
    R, C = min(MM, NN), max(MM, NN)
    p, i = np.meshgrid(np.arange(R + C + 1), np.arange(R + 1), indexing="ij")
    outside = (p - i < 0) | (p - i > C)
    assert (stack.numpy()[:, outside] == 0).all()
    assert (stack.numpy()[:, (i == 0) & ~outside] == 1).all()


@pytest.mark.parametrize("dyadic", [1, 2])
def test_collapse_sums_the_blocks(rng, dyadic):
    f = 2 ** dyadic
    for shape in ((2, 3 * f, 5 * f), (2, 5 * f, 3 * f)):
        KK = rng.normal(size=shape)
        want = KK.reshape(2, shape[1] // f, f, shape[2] // f, f).sum((2, 4))
        np.testing.assert_allclose(
            scan_solver.collapse_refined(torch.tensor(KK), f).numpy(), want,
            rtol=1e-13)


@pytest.mark.parametrize("naive", [False, True])
@pytest.mark.parametrize("dyadic", [0, 1, 2])
@pytest.mark.parametrize("M,N", [(6, 9), (9, 6), (1, 5)])
def test_plain_adjoint_matches_jax_grid_route(rng, M, N, dyadic, naive):
    inc = _inc(rng, 3, M, N)
    g = rng.normal(size=3)
    (want,) = jsolve._grid_route_bwd(jnp.asarray(inc), jnp.asarray(g), naive,
                                     "scan", dyadic)
    got = grid_route_bwd(torch.tensor(inc), torch.tensor(g), naive, dyadic)
    if M == 1:
        assert got.shape == (3, 0, N - 1)
        return
    _close(got, want)
    # the plain versions of K2-stack -> K3<inc>, weighted by g, agree too
    _, stack = cuda_solver.inc_solve_stack_plain(torch.tensor(inc), dyadic,
                                                 naive)
    ct = cuda_solver.inc_adjoint_plain(torch.tensor(inc), stack, dyadic,
                                       naive)
    _close(ct * torch.tensor(g)[:, None, None], want)


@pytest.mark.parametrize("dyadic", [0, 1, 2])
def test_solve_gradient_matches_jax(rng, dyadic):
    inc = _inc(rng, 6, 7, 10).reshape(2, 3, 6, 9)
    R = rng.normal(size=(2, 3))
    want = jax.grad(lambda a: jnp.sum(R * jsolve.solve(
        a, solver="scan", dyadic_order=dyadic)))(jnp.asarray(inc))
    for grade in ("auto", "f32", "df64"):
        t = torch.tensor(inc, requires_grad=True)
        torch.sum(torch.tensor(R) * solve(t, dyadic_order=dyadic,
                                          grad_solver=grade)).backward()
        _close(t.grad, want)


def test_refined_plain_chain_agrees_with_the_refined_grid(rng):
    """The plain K3<gen> on a stack equals the adjoint from JAX's refined
    grid, at dyadic 1 on unequal lengths."""
    X = make_paths(rng, 2, 6, 3, scale=0.6)
    Y = make_paths(rng, 2, 9, 3, scale=0.6)
    ii = torch.arange(2)
    tX, tY = torch.tensor(X), torch.tensor(Y)
    _, stack = cuda_gen.rbf_gen_solve_stack_plain(tX, tY, ii, ii, 0.5, 1)
    ct = cuda_gen.rbf_gen_adjoint_plain(tX, tY, ii, ii, 0.5, stack, 1)
    inc = cuda_gen.gen_increments(tX, tY, 0.5)
    (want,) = jsolve._grid_route_bwd(jnp.asarray(inc.numpy()),
                                     jnp.ones(2), False, "scan", 1)
    _close(ct, want)
