"""The sparse-checkpoint adjoint on CPU tensors, against the JAX package and
the port's full-stack adjoint: the plain version of K2-sparse (the full
stack's checkpoint rows), the plain rebuild of the full stack from them
(the plain version of K8's in-kernel recompute), the plain K8 against JAX
``_grid_route_bwd`` on the scan tier, and an estimator routed through the
``ckpt`` tier by patching the resolver to its CUDA rows and the gate's pair
count up. Bars: f64 gradients 1e-9 of max |grad|, f32 gradients 1e-3."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigkernel_tpu as sk
from sigkernel_tpu.ops import solve as jsolve
from sigkernel_tpu.utils import double_difference as jdd

import sigkernel_tpu_torch as skt
from sigkernel_tpu_torch.ops import cuda_solver, routes, scan_solver, solve
from sigkernel_tpu_torch.utils import dyadic_refine

from conftest import make_paths
from test_torch_adjoint import _close

GRAD_BAR = {torch.float64: 1e-9, torch.float32: 1e-3}


def _inc(rng, batch, M, N, sigma=0.6):
    X = make_paths(rng, batch, M, 2, scale=0.6)
    Y = make_paths(rng, batch, N, 2, scale=0.6)
    return np.asarray(jdd(sk.RBFKernel(sigma).batch_kernel(X, Y)))


@pytest.mark.parametrize("W", [2, 3, cuda_solver.CKPT_WINDOW, 64])
@pytest.mark.parametrize("naive", [False, True])
@pytest.mark.parametrize("dyadic", [0, 1, 2])
@pytest.mark.parametrize("M,N", [(6, 9), (9, 6), (2, 5)])
def test_sparse_stack_rebuilds_the_full_stack(rng, monkeypatch, W, naive,
                                              dyadic, M, N):
    """The sparse stack is the full stack's rows (w W, w W + 1), one pair
    per window of the adjoint's diagonals, and the windows re-swept from
    them give the full stack back bit for bit."""
    monkeypatch.setattr(cuda_solver, "CKPT_WINDOW", W)
    inc = torch.tensor(_inc(rng, 2, M, N))
    v, stack = cuda_solver.inc_solve_stack_plain(inc, dyadic, naive)
    sv, sparse = cuda_solver.inc_solve_sparse(inc, dyadic, naive)
    f = 2 ** dyadic
    MM, NN = (M - 1) * f, (N - 1) * f
    R, C = min(MM, NN), max(MM, NN)
    assert sparse.shape == cuda_solver.sparse_shape(2, MM, NN)
    assert sparse.shape[1] == 2 * ((R + C - 2) // W + 1)
    assert torch.equal(sv, v)
    assert torch.equal(sparse, scan_solver.stack_to_sparse(stack, W))
    assert torch.equal(scan_solver.sparse_to_stack(
        sparse, dyadic_refine(inc, dyadic), W, naive), stack)


@pytest.mark.parametrize("W", [2, cuda_solver.CKPT_WINDOW])
@pytest.mark.parametrize("naive", [False, True])
@pytest.mark.parametrize("dyadic", [0, 1, 2])
@pytest.mark.parametrize("M,N", [(6, 9), (9, 6), (1, 5)])
def test_ckpt_adjoint_matches_jax_and_the_full_stack(rng, monkeypatch, W,
                                                     naive, dyadic, M, N):
    """K8's plain version against JAX ``_grid_route_bwd`` on the scan tier,
    and equal to K3<inc>'s on the full stack bit for bit."""
    monkeypatch.setattr(cuda_solver, "CKPT_WINDOW", W)
    inc = _inc(rng, 3, M, N)
    g = rng.normal(size=3)
    (want,) = jsolve._grid_route_bwd(jnp.asarray(inc), jnp.asarray(g), naive,
                                     "scan", dyadic)
    t = torch.tensor(inc)
    if M == 1:  # a length-1 path: no stack, and the route returns zeros
        got = solve.inc_route_bwd(t, torch.tensor(g), naive, dyadic)
        assert got.shape == (3, 0, N - 1)
        return
    before = cuda_solver.CKPT_COUNTS["plain"]
    _, sparse = cuda_solver.inc_solve_sparse(t, dyadic, naive)
    ct = cuda_solver.inc_adjoint_ckpt(t, sparse, dyadic, naive)
    assert cuda_solver.CKPT_COUNTS["plain"] == before + 1
    _close(ct * torch.tensor(g)[:, None, None], want)
    _, stack = cuda_solver.inc_solve_stack(t, dyadic, naive)
    assert torch.equal(ct, cuda_solver.inc_adjoint(t, stack, dyadic, naive))


def test_ckpt_geometry_gate(monkeypatch):
    """Any grid with both sides at least 1, at any window of 2 or more
    diagonals: the port keeps no ``f in (2, 4)`` restriction. A length-1
    path stores nothing and keeps the full tier; a window of one diagonal
    raises."""
    assert routes.resolve_inc_tier((4092, 4092), 8, backward=True) == "ckpt"
    assert routes.resolve_inc_tier((0, 1 << 20), 8, backward=True) == "full"
    monkeypatch.setattr(cuda_solver, "CKPT_WINDOW", 2)
    assert cuda_solver.sparse_shape(1, 3, 17) == (1, 2 * 10, 4)
    monkeypatch.setattr(cuda_solver, "CKPT_WINDOW", 1)
    with pytest.raises(ValueError, match="at least 2 diagonals"):
        cuda_solver.inc_solve_sparse(torch.zeros(1, 3, 17))


@pytest.fixture
def tier_on_cpu(monkeypatch):
    """Steer every tile on CPU tensors onto the ``inc`` family, as on the
    card; the test then sets the ckpt gate's pair count."""
    orig = routes.resolve_family

    def steered(static_kernel, device_type, solver, **gates):
        if solver == "scan":
            return orig(static_kernel, device_type, solver, **gates)
        return "inc"

    monkeypatch.setattr(routes, "resolve_family", steered)
    return lambda pairs: monkeypatch.setattr(routes, "CKPT_MIN_PAIRS", pairs)


@pytest.mark.parametrize("max_batch", [None, 2])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_mmd_through_the_ckpt_tier_matches_jax(rng, tier_on_cpu, dtype,
                                               max_batch):
    """``sig_mmd`` forward and backward in X and sigma on the sparse route
    (K2-sparse -> K8's plain versions) against ``jax.grad`` of the JAX scan
    tier, and equal to the full-stack route (K2-stack -> K3<inc>)."""
    X = make_paths(rng, 3, 7, 2, scale=0.6)
    Y = make_paths(rng, 4, 9, 2, scale=0.6)
    kw = dict(dyadic_order=1, max_batch=max_batch)
    want = jax.grad(lambda x, s: sk.sig_mmd(
        sk.RBFKernel(s), x, jnp.asarray(Y), solver="scan", **kw),
        argnums=(0, 1))(jnp.asarray(X), jnp.asarray(0.7))
    runs = {}
    for tier, pairs in (("ckpt", 1 << 40), ("full", 0)):
        tier_on_cpu(pairs)
        assert routes.resolve_inc_tier((12, 16), 8, backward=True) == tier
        counts = (cuda_solver.SPARSE_COUNTS if tier == "ckpt"
                  else cuda_solver.STACK_COUNTS)
        before = counts["plain"]
        x = torch.tensor(X, dtype=dtype, requires_grad=True)
        sigma = torch.tensor(0.7, dtype=dtype, requires_grad=True)
        skt.sig_mmd(skt.RBFKernel(sigma), x, torch.tensor(Y, dtype=dtype),
                    pair_chunk=5, **kw).backward()
        assert counts["plain"] > before
        runs[tier] = (x.grad, sigma.grad)
    for got, full, w in zip(runs["ckpt"], runs["full"], want):
        assert torch.equal(got, full)
        _close(got, w, GRAD_BAR[dtype])


def test_stack_budget_sets_the_sparse_chunk(monkeypatch):
    """The sparse route's chunk keeps its sparse stacks and K8's scratch
    within ``STACK_BYTES``: 126 pairs at length 1024, dyadic 2 in double
    (68.0 MB a pair at the window of 8: the sparse stack, and the band
    kernel's hand-off rows between its 32 bands of 128 rows and their
    counters, more than the one-block kernel's window of 8 diagonals)."""
    W = cuda_solver.CKPT_WINDOW
    band = 31 * 4093 * 8 + 4 * 32
    assert band > W * 4093 * 8
    per_pair = np.prod(cuda_solver.sparse_shape(1, 4092, 4092)) * 8 + band
    assert routes.tier_bytes("ckpt", (4092, 4092), 8) == per_pair
    assert routes.chunk_pairs(560, per_pair) == (
        routes.STACK_BYTES // per_pair) == 126
    # one band (R <= 128) hands nothing on: the one-block window counts
    assert routes.tier_bytes("ckpt", (100, 300), 4) == 4 * (
        np.prod(cuda_solver.sparse_shape(1, 100, 300)) + W * 101)
    monkeypatch.setattr(routes, "STACK_BYTES", 3 * per_pair)
    assert routes.chunk_pairs(560, per_pair) == 3


@pytest.mark.parametrize("kernel", ["rbf", "linear"])
@pytest.mark.parametrize("tier", ["ckpt", "full"])
def test_gradient_keeps_one_chunk_of_grids(rng, tier_on_cpu, monkeypatch,
                                           tier, kernel):
    """With a gradient, the ``inc`` family builds each chunk's increment
    grids and drops them, and the backward builds them again: with
    ``STACK_BYTES`` set to 3 pairs' grids, no forward solve and no backward
    stack call holds more than 3 of the 21 pairs of ``sig_scoring_rule``'s
    tiles, the value is unchanged and the gradients in X and the kernel's
    hyper-parameter agree with the unbudgeted run (the chunk sums add in
    another order)."""
    X = make_paths(rng, 5, 7, 2, scale=0.6)
    y = make_paths(rng, 1, 9, 2, scale=0.6)
    make = {"rbf": skt.RBFKernel, "linear": skt.LinearKernel}[kernel]
    tier_on_cpu(1 << 40 if tier == "ckpt" else 0)

    def run():
        x = torch.tensor(X, requires_grad=True)
        h = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
        v = skt.sig_scoring_rule(make(h), x, torch.tensor(y), dyadic_order=1)
        v.backward()
        return v.detach(), x.grad, h.grad

    want = run()
    calls = {"fwd": [], "bwd": []}

    def recording(fn, key):
        def call(inc, *args, **kwargs):
            calls[key].append(inc.shape[0])
            return fn(inc, *args, **kwargs)
        return call

    monkeypatch.setattr(cuda_solver, "inc_solve_final_plain", recording(
        cuda_solver.inc_solve_final_plain, "fwd"))
    stack_fn = ("inc_solve_sparse_plain" if tier == "ckpt"
                else "inc_solve_stack_plain")
    monkeypatch.setattr(cuda_solver, stack_fn, recording(
        getattr(cuda_solver, stack_fn), "bwd"))
    # 3 pairs of the 6 x 6 base grids of X with X, 2 of X with y (6 x 8)
    monkeypatch.setattr(routes, "STACK_BYTES", 3 * routes.grid_bytes(6, 6, 8))
    got = run()
    assert sum(calls["fwd"]) == sum(calls["bwd"]) == 15 + 5
    assert calls["fwd"] == [3] * 5 + [2, 2, 1]
    assert max(calls["bwd"]) <= 3
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        _close(g, w.numpy(), 1e-13)
