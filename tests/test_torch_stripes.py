"""Grids too tall for one block, on CPU tensors, against the JAX package:
the plain stripe sweep (``scan_solver.solve_stripe``/``solve_stripe_grid``),
the stripe chain of :mod:`sigkernel_tpu_torch.ops.cuda_blocked` (the plain
versions of K7, K7-stack and K3<inc, boundary>, which the card holds its
kernels to) at a forced small stripe height, the striped adjoint, and an
estimator routed through the stripes by patching the resolver to its CUDA
rows. Bars: f64 values 1e-10 relative, f64 gradients 1e-9 of max |grad|;
f32 values 1e-4, f32 gradients 1e-3."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigkernel_tpu as sk
from sigkernel_tpu.ops import scan_solver as jscan
from sigkernel_tpu.ops import solve as jsolve
from sigkernel_tpu.utils import double_difference as jdd
from sigkernel_tpu.utils import dyadic_refine as jrefine

import sigkernel_tpu_torch as skt
from sigkernel_tpu_torch.ops import _build, cuda_blocked, cuda_solver, routes
from sigkernel_tpu_torch.ops import scan_solver

from conftest import make_paths
from test_torch_adjoint import _close

VALUE_BAR = {torch.float64: 1e-10, torch.float32: 1e-4}
GRAD_BAR = {torch.float64: 1e-9, torch.float32: 1e-3}


def _inc(rng, batch, M, N, sigma=0.6):
    X = make_paths(rng, batch, M, 2, scale=0.6)
    Y = make_paths(rng, batch, N, 2, scale=0.6)
    return np.asarray(jdd(sk.RBFKernel(sigma).batch_kernel(X, Y)))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("naive", [False, True])
@pytest.mark.parametrize("dyadic", [0, 1, 2])
@pytest.mark.parametrize("M,N", [(10, 15), (15, 10)])
def test_stripe_solve_matches_jax_scan(rng, dtype, naive, dyadic, M, N):
    """Three stripes of 4 base rows over 9 (the last one short), both
    orientations: the corner equals JAX's scan tier on the refined grid."""
    inc = _inc(rng, 3, M, N)
    want = np.asarray(jscan.solve_final(jrefine(jnp.asarray(inc), dyadic),
                                        naive=naive))
    f = 2 ** dyadic
    before = cuda_blocked.COUNTS["plain"]
    got = cuda_blocked.solve_final(torch.tensor(inc, dtype=dtype), dyadic,
                                   naive, rows=4 * f)
    assert cuda_blocked.COUNTS["plain"] == before + 3
    assert got.dtype == dtype and got.shape == (3,)
    np.testing.assert_allclose(got.double().numpy(), want,
                               rtol=VALUE_BAR[dtype])


@pytest.mark.parametrize("naive", [False, True])
@pytest.mark.parametrize("dyadic", [0, 1, 2])
def test_boundary_chain_matches_jax_solve_stripe(rng, naive, dyadic):
    """Stripe by stripe, the port's bottom rows (plain sweep, the K7 and
    K7-stack wrappers, and the reverse problem's stripes through ``flip``)
    equal JAX ``scan_solver.solve_stripe`` from the same boundary; the
    stripe grid's rows are the whole grid's."""
    inc = _inc(rng, 2, 8, 12)
    f, rows = 2 ** dyadic, 3 * 2 ** dyadic
    ref = jrefine(jnp.asarray(inc), dyadic)
    R, C = ref.shape[-2:]
    grid = scan_solver.solve_grid(torch.tensor(np.asarray(ref)), naive)
    rev = jnp.flip(ref, axis=(-2, -1))
    pad = jnp.concatenate([jnp.zeros((2, 2 * f, C)), rev], axis=-2)
    t = torch.tensor(inc)
    jbd = jnp.ones((2, C + 1))
    jbd_r = jnp.ones((2, C + 1))
    bd = torch.ones(2, C + 1, dtype=torch.float64)
    bd_r = bd.clone()
    S = -(-R // rows)
    for s in range(S):
        row0, h = s * rows, min(rows, R - s * rows)
        jbd = jscan.solve_stripe(ref[:, row0:row0 + h], jbd, naive=naive)
        u = torch.tensor(np.asarray(ref[:, row0:row0 + h]))
        plain = scan_solver.solve_stripe(u, bd, naive)
        sgrid = scan_solver.solve_stripe_grid(u, bd, naive)
        bottom = cuda_blocked.stripe_solve(t, bd, row0, h, dyadic, naive)
        b2, stack = cuda_blocked.stripe_solve_stack(t, bd, row0, h, dyadic,
                                                    naive)
        np.testing.assert_allclose(plain.numpy(), np.asarray(jbd),
                                   rtol=1e-13)
        for other in (bottom, b2, sgrid[..., -1, :]):
            assert torch.equal(other, plain)
        assert torch.equal(sgrid[..., 0, :], bd)
        assert torch.equal(sgrid, grid[..., row0:row0 + h + 1, :])
        assert torch.equal(stack, scan_solver.grid_to_stack(sgrid))
        bd = plain
        # the reverse problem, zero-padded to S whole stripes at its start
        r0 = (S - 1 - s) * rows
        jbd_r = jscan.solve_stripe(pad[:, s * rows:(s + 1) * rows], jbd_r,
                                   naive=naive)
        bd_r = cuda_blocked.stripe_solve(t, bd_r, r0, rows, dyadic, naive,
                                         flip=True)
        np.testing.assert_allclose(bd_r.numpy(), np.asarray(jbd_r),
                                   rtol=1e-13)
    np.testing.assert_allclose(bd[:, -1].numpy(), np.asarray(
        jscan.solve_final(ref, naive=naive)), rtol=1e-13)


@pytest.mark.parametrize("naive", [False, True])
@pytest.mark.parametrize("dyadic", [0, 1, 2])
@pytest.mark.parametrize("M,N", [(8, 13), (13, 8)])
def test_striped_adjoint_matches_jax_grid_route(rng, naive, dyadic, M, N):
    """The striped adjoint (stripes of 2 base rows over 7, zero-padded to
    8) against JAX ``_grid_route_bwd`` on the scan tier, and equal to the
    one-block adjoint (K2-stack -> K3<inc>) bit for bit."""
    inc = _inc(rng, 3, M, N)
    g = rng.normal(size=3)
    (want,) = jsolve._grid_route_bwd(jnp.asarray(inc), jnp.asarray(g), naive,
                                     "scan", dyadic)
    t = torch.tensor(inc)
    counts = (cuda_blocked.STACK_COUNTS, cuda_blocked.ADJOINT_COUNTS)
    before = [c["plain"] for c in counts]
    ct = cuda_blocked.adjoint(t, dyadic, naive, rows=2 * 2 ** dyadic)
    assert [c["plain"] for c in counts] == [b + 4 for b in before]
    _close(ct * torch.tensor(g)[:, None, None], want)
    _, stack = cuda_solver.inc_solve_stack(t, dyadic, naive)
    assert torch.equal(ct, cuda_solver.inc_adjoint(t, stack, dyadic, naive))


@pytest.fixture
def long_routes_on_cpu(monkeypatch):
    """Steer every tile on CPU tensors onto the ``inc`` family, as on the
    card, with the row bound at 10 rows: forward and backward then take
    the stripes, through the plain versions of K7, K7-stack and K3<inc,
    boundary>."""
    orig = routes.resolve_family

    def steered(static_kernel, device_type, solver, **gates):
        if solver == "scan":
            return orig(static_kernel, device_type, solver, **gates)
        return "inc"

    monkeypatch.setattr(routes, "resolve_family", steered)
    monkeypatch.setattr(_build, "max_rows", lambda itemsize: 10)
    counts = (cuda_blocked.COUNTS, cuda_blocked.STACK_COUNTS,
              cuda_blocked.ADJOINT_COUNTS)
    before = [c["plain"] for c in counts]
    yield
    assert all(c["plain"] > b for c, b in zip(counts, before))


@pytest.mark.parametrize("max_batch", [None, 2])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_mmd_through_stripes_matches_jax(rng, long_routes_on_cpu, dtype,
                                         max_batch):
    """``sig_mmd`` forward and backward in X and sigma on the stripe routes
    (refined sides 14 and 18 past a 10-row bound: stripes of 10 rows; the
    Gram branch and the lincomb branch) against ``jax.grad`` of the JAX
    scan tier."""
    X = make_paths(rng, 3, 8, 2, scale=0.6)
    Y = make_paths(rng, 4, 10, 2, scale=0.6)
    kw = dict(dyadic_order=1, max_batch=max_batch)
    want_v, want_g = jax.value_and_grad(
        lambda x, s: sk.sig_mmd(sk.RBFKernel(s), x, jnp.asarray(Y),
                                solver="scan", **kw),
        argnums=(0, 1))(jnp.asarray(X), jnp.asarray(0.7))
    x = torch.tensor(X, dtype=dtype, requires_grad=True)
    sigma = torch.tensor(0.7, dtype=dtype, requires_grad=True)
    v = skt.sig_mmd(skt.RBFKernel(sigma), x, torch.tensor(Y, dtype=dtype),
                    pair_chunk=5, **kw)
    v.backward()
    assert abs(float(v.detach()) - float(want_v)) <= VALUE_BAR[dtype] * max(
        abs(float(want_v)), 1.0)
    _close(x.grad, want_g[0], GRAD_BAR[dtype])
    _close(sigma.grad, want_g[1], GRAD_BAR[dtype])
