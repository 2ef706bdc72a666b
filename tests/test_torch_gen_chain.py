"""The whole ``gen`` chain on CPU tensors against the JAX package: the
plain versions of K1-stack -> K3<gen> -> K4, which the card holds its kernels
to, steered onto CPU tensors by patching ``routes.resolve_family`` through
the module object (as the routes docstring allows). Gradients in the paths,
the weights and sigma of lincomb and Gram estimators (both with the ``sym``
triangle) against ``jax.grad`` of the JAX scan tier: float64 within 1e-9 of
max |grad|."""
import math

import jax
import jax.numpy as jnp
import pytest
import torch

import sigkernel_tpu as sk

import sigkernel_tpu_torch as skt
from sigkernel_tpu_torch.ops import cuda_gen, cuda_solver, incvjp, routes

from conftest import make_paths
from test_torch_adjoint import _close


@pytest.fixture
def gen_on_cpu(monkeypatch):
    """Steer RBF tiles on CPU tensors onto the ``gen`` family: its Functions
    then run the plain versions of K1-stack, K3<gen> and K4."""
    orig = routes.resolve_family

    def steered(static_kernel, device_type, solver, **gates):
        if type(static_kernel) is skt.RBFKernel and solver != "scan":
            return "gen"
        return orig(static_kernel, device_type, solver, **gates)

    monkeypatch.setattr(routes, "resolve_family", steered)
    counts = (cuda_gen.STACK_COUNTS, cuda_gen.ADJOINT_COUNTS, incvjp.COUNTS)
    before = [c["plain"] for c in counts]
    yield
    assert all(c["plain"] > b for c, b in zip(counts, before))


@pytest.mark.parametrize("naive", [False, True])
@pytest.mark.parametrize("dyadic", [0, 1, 2])
@pytest.mark.parametrize("M,N", [(6, 9), (9, 6)])
def test_gen_chain_on_cpu_matches_jax(rng, gen_on_cpu, M, N, dyadic, naive):
    X = make_paths(rng, 3, M, 2, scale=0.6)
    Y = make_paths(rng, 4, N, 2, scale=0.6)
    W = rng.normal(size=(3, 4))
    Wx = rng.normal(size=(3, 3))
    kw = dict(dyadic_order=dyadic, naive=naive)

    def jloss(x, y, w, wx, s):
        k = sk.RBFKernel(s)
        return (sk.sig_gram_lincomb(k, x, y, w, pair_chunk=5, **kw)
                + sk.sig_gram_lincomb(k, x, x, wx, sym=True, pair_chunk=4,
                                      **kw)
                + jnp.sum(w * sk.sig_gram(k, x, y, max_batch=2, **kw))
                + jnp.sum(wx * sk.sig_gram(k, x, x, sym=True, **kw)))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (X, Y, W, Wx)), jnp.asarray(0.7))
    ts = [torch.tensor(a, requires_grad=True) for a in (X, Y, W, Wx)]
    sigma = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    x, y, w, wx = ts
    k = skt.RBFKernel(sigma)
    S = (skt.sig_gram_lincomb(k, x, y, w, pair_chunk=5, **kw)
         + skt.sig_gram_lincomb(k, x, x, wx, sym=True, pair_chunk=4, **kw)
         + torch.sum(w * skt.sig_gram(k, x, y, max_batch=2, **kw))
         + torch.sum(wx * skt.sig_gram(k, x, x, sym=True, **kw)))
    S.backward()
    for t, wg in zip(ts + [sigma], want):
        _close(t.grad, wg)


@pytest.mark.parametrize("dyadic", [0, 2])
def test_gen_chain_f32_grade_on_cpu(rng, gen_on_cpu, dyadic):
    """grad_solver='f32' on float64 paths: float64 values, the kernel chain
    in float32, gradients cast back to float64; within 1e-4 of JAX's
    float64 gradients at this size."""
    X = make_paths(rng, 3, 8, 2, scale=0.6)
    Y = make_paths(rng, 2, 6, 2, scale=0.6)
    W = rng.normal(size=(3, 2))
    want = jax.grad(lambda x, s: sk.sig_gram_lincomb(
        sk.RBFKernel(s), x, jnp.asarray(Y), jnp.asarray(W),
        dyadic_order=dyadic), argnums=(0, 1))(jnp.asarray(X),
                                              jnp.asarray(0.5))
    x = torch.tensor(X, requires_grad=True)
    sigma = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
    S = skt.sig_gram_lincomb(skt.RBFKernel(sigma), x, torch.tensor(Y),
                             torch.tensor(W), dyadic_order=dyadic,
                             grad_solver="f32")
    S.backward()
    assert S.dtype == x.grad.dtype == torch.float64
    S_want = sk.sig_gram_lincomb(sk.RBFKernel(0.5), jnp.asarray(X),
                                 jnp.asarray(Y), jnp.asarray(W),
                                 dyadic_order=dyadic)
    assert abs(float(S.detach()) - float(S_want)) <= 1e-12 * abs(float(S_want))
    _close(x.grad, want[0], 1e-4)
    _close(sigma.grad, want[1], 1e-4)


@pytest.mark.parametrize("grade", ["auto", "f32"])
def test_lincomb_gen_chunk_keeps_its_stacks_within_the_budget(
        rng, gen_on_cpu, monkeypatch, grade):
    """A lincomb chunk on the ``gen`` family (12 pairs in one
    ``pair_chunk``) builds its K1-stacks in sub-chunks of
    ``routes.chunk_pairs`` pairs: with ``STACK_BYTES`` set to 3 pairs' stacks, no K1-stack call
    holds more than 3 pairs, the value is unchanged and the gradients agree
    with the unbudgeted run within rounding (the sub-chunk sums add in
    another order: 1e-13 in the float64 grade, a few float32 ulps in the
    float32 one)."""
    X = make_paths(rng, 4, 7, 2, scale=0.6)
    Y = make_paths(rng, 3, 9, 2, scale=0.6)
    W = rng.normal(size=(4, 3))

    def run():
        x = torch.tensor(X, requires_grad=True)
        y = torch.tensor(Y, requires_grad=True)
        sigma = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
        S = skt.sig_gram_lincomb(skt.RBFKernel(sigma), x, y, torch.tensor(W),
                                 dyadic_order=1, pair_chunk=12,
                                 grad_solver=grade)
        S.backward()
        return S.detach(), x.grad, y.grad, sigma.grad

    want = run()
    pairs = []
    plain = cuda_gen.rbf_gen_solve_stack_plain

    def recording(X, Y, ii, jj, *args, **kwargs):
        pairs.append(ii.shape[0])
        return plain(X, Y, ii, jj, *args, **kwargs)

    monkeypatch.setattr(cuda_gen, "rbf_gen_solve_stack_plain", recording)
    size = 8 if grade == "auto" else 4
    per_pair = math.prod(cuda_solver.stack_shape(1, 12, 16)) * size
    monkeypatch.setattr(routes, "STACK_BYTES", 3 * per_pair)
    got = run()
    assert pairs == [3, 3, 3, 3]
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        _close(g, w.numpy(), 1e-13 if grade == "auto" else 1e-6)


def test_gen_refuses_other_kernels(rng, monkeypatch):
    class _Scaled(skt.RBFKernel):
        pass

    monkeypatch.setattr(routes, "resolve_family", lambda k, d, s, **gates: "gen")
    X = torch.tensor(make_paths(rng, 2, 5, 2), requires_grad=True)
    with pytest.raises(TypeError, match="RBFKernel"):
        skt.sig_gram_lincomb(_Scaled(0.5), X, X, torch.ones(2, 2,
                                                             dtype=X.dtype))
