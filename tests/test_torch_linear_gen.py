"""The ``lgen`` family (Linear increments generated in-kernel, K6) on CPU
tensors against the JAX package: the plain version of K6 against the JAX
scan tier's Linear ``sig_kernel`` / ``sig_gram``, and values and gradients
through ``sigkernel._LinearGen`` (whose backward runs the plain versions of
K2-stack and K3<inc> on the recomputed grid) against ``jax.grad``. The
Function is reached by patching ``routes.resolve_family`` through the module
object, as the routes docstring allows; its wrappers then take their plain
versions for CPU tensors.

Bars: float64 values within 1e-10 relative, gradients within 1e-9 of
max |grad|; float32 values within 1e-4 of max |K| of JAX in float64 (the
Linear signature kernel crosses 0, so an entry-wise relative error in
float32 measures how near 0 an entry is)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigkernel_tpu as sk

import sigkernel_tpu_torch as skt
from sigkernel_tpu_torch.ops import cuda_lgen, cuda_solver, routes

from conftest import make_paths
from test_torch_adjoint import _close


def _rel(got, want):
    want = np.asarray(want)
    return np.max(np.abs(got.detach().double().numpy() - want)
                  / np.abs(want))


@pytest.fixture
def lgen_on_cpu(monkeypatch):
    """Steer exactly-``LinearKernel`` tiles on CPU tensors onto ``lgen``."""
    orig = routes.resolve_family

    def steered(static_kernel, device_type, solver, **gates):
        if type(static_kernel) is skt.LinearKernel and solver != "scan":
            return "lgen"
        return orig(static_kernel, device_type, solver, **gates)

    monkeypatch.setattr(routes, "resolve_family", steered)
    before = cuda_lgen.COUNTS["plain"]
    yield
    assert cuda_lgen.COUNTS["plain"] > before


def _check(got, want, dtype):
    if dtype == np.float64:
        assert _rel(got, want) <= 1e-10
    else:
        _close(got, want, 1e-4)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("dyadic,naive", [(0, False), (1, True), (2, False)])
@pytest.mark.parametrize("M,N", [(7, 12), (12, 7)])
def test_plain_version_matches_jax_scan_tier(rng, M, N, dyadic, naive, dtype):
    X = make_paths(rng, 3, M, 3, scale=0.8)
    Y = make_paths(rng, 4, N, 3, scale=0.8)
    jk = sk.LinearKernel(0.9)
    want = sk.sig_gram(jk, jnp.asarray(X), jnp.asarray(Y),
                       dyadic_order=dyadic, naive=naive, solver="scan")
    ii = torch.arange(3).repeat_interleave(4)
    jj = torch.arange(4).repeat(3)
    before = cuda_lgen.COUNTS["plain"]
    got = cuda_lgen.linear_gen_solve_final(  # CPU: the plain version
        torch.tensor(X.astype(dtype)), torch.tensor(Y.astype(dtype)), ii, jj,
        0.9, dyadic, naive)
    assert cuda_lgen.COUNTS["plain"] == before + 1
    assert got.dtype == torch.tensor(X.astype(dtype)).dtype
    _check(got.reshape(3, 4), want, dtype)
    # the pairwise kernel: X[p] with Y[p]
    Yp = make_paths(rng, 3, N, 3, scale=0.8)
    want = sk.sig_kernel(jk, jnp.asarray(X), jnp.asarray(Yp),
                         dyadic_order=dyadic, naive=naive, solver="scan")
    ar = torch.arange(3)
    got = cuda_lgen.linear_gen_solve_final(
        torch.tensor(X.astype(dtype)), torch.tensor(Yp.astype(dtype)), ar,
        ar, torch.tensor(0.9, dtype=torch.float64), dyadic, naive)
    _check(got, want, dtype)


@pytest.mark.parametrize("M,N,dyadic", [(6, 9, 0), (9, 6, 2)])
def test_lgen_values_and_gradients_match_jax(rng, lgen_on_cpu, M, N, dyadic):
    """Kernel, tiled Gram, sym triangle and lincomb through ``_LinearGen``:
    values and gradients in the paths, the weights and ``scale``."""
    X = make_paths(rng, 3, M, 2, scale=0.7)
    Y = make_paths(rng, 4, N, 2, scale=0.7)
    Xp = make_paths(rng, 3, N, 2, scale=0.7)
    W = rng.normal(size=(3, 4))
    Wx = rng.normal(size=(3, 3))
    kw = dict(dyadic_order=dyadic)

    def jparts(x, y, xp, w, wx, s):
        k = sk.LinearKernel(s)
        return (jnp.sum(jnp.sin(sk.sig_kernel(k, x, xp, **kw))),
                jnp.sum(w * sk.sig_gram(k, x, y, max_batch=2, **kw)),
                jnp.sum(wx * sk.sig_gram(k, x, x, sym=True, **kw)),
                sk.sig_gram_lincomb(k, x, y, w, pair_chunk=5, **kw))

    args = [jnp.asarray(a) for a in (X, Y, Xp, W, Wx)] + [jnp.asarray(0.8)]
    want_vals = jparts(*args)
    want = jax.grad(lambda *a: sum(jparts(*a)),
                    argnums=tuple(range(6)))(*args)
    ts = [torch.tensor(a, requires_grad=True) for a in (X, Y, Xp, W, Wx)]
    scale = torch.tensor(0.8, dtype=torch.float64, requires_grad=True)
    x, y, xp, w, wx = ts
    k = skt.LinearKernel(scale)
    counts = (cuda_solver.STACK_COUNTS, cuda_solver.ADJOINT_COUNTS)
    before = [c["plain"] for c in counts]
    parts = (torch.sum(torch.sin(skt.sig_kernel(k, x, xp, **kw))),
             torch.sum(w * skt.sig_gram(k, x, y, max_batch=2, **kw)),
             torch.sum(wx * skt.sig_gram(k, x, x, sym=True, **kw)),
             skt.sig_gram_lincomb(k, x, y, w, pair_chunk=5, **kw))
    for got, wv in zip(parts, want_vals):
        assert abs(float(got.detach()) - float(wv)) <= 1e-10 * abs(float(wv))
    sum(parts).backward()
    # the backward ran the increment-grid adjoint (K2-stack, K3<inc>)
    assert all(c["plain"] > b for c, b in zip(counts, before))
    for t, wg in zip(ts + [scale], want):
        _close(t.grad, wg)


def test_lgen_f32_grade_and_float32_inputs(rng, lgen_on_cpu):
    """float64 paths with ``grad_solver="f32"`` (the adjoint in float32) and
    float32 paths, against JAX's float64 gradients at 1e-4 of max |grad|."""
    X = make_paths(rng, 3, 8, 2, scale=0.7)
    Y = make_paths(rng, 2, 6, 2, scale=0.7)
    W = rng.normal(size=(3, 2))
    want = jax.grad(lambda x, s: sk.sig_gram_lincomb(
        sk.LinearKernel(s), x, jnp.asarray(Y), jnp.asarray(W),
        dyadic_order=1), argnums=(0, 1))(jnp.asarray(X), jnp.asarray(0.8))
    for dtype, grade in ((torch.float64, "f32"), (torch.float32, "auto")):
        x = torch.tensor(X, dtype=dtype, requires_grad=True)
        scale = torch.tensor(0.8, dtype=dtype, requires_grad=True)
        S = (torch.tensor(W, dtype=dtype) * skt.sig_gram(
            skt.LinearKernel(scale), x, torch.tensor(Y, dtype=dtype),
            dyadic_order=1, grad_solver=grade)).sum()
        S.backward()
        assert x.grad.dtype == scale.grad.dtype == dtype
        _close(x.grad, want[0], 1e-4)
        _close(scale.grad, want[1], 1e-4)


def test_lgen_length_one_path(rng, lgen_on_cpu):
    X = torch.tensor(make_paths(rng, 2, 1, 2), requires_grad=True)
    Y = torch.tensor(make_paths(rng, 3, 6, 2), requires_grad=True)
    scale = torch.tensor(0.8, dtype=torch.float64, requires_grad=True)
    K = skt.sig_gram(skt.LinearKernel(scale), X, Y, dyadic_order=1)
    assert torch.equal(K, torch.ones(2, 3, dtype=K.dtype))
    K.sum().backward()
    assert not (X.grad.any() or Y.grad.any() or scale.grad.any())


def test_lgen_refuses_other_kernels(rng, monkeypatch):
    monkeypatch.setattr(routes, "resolve_family", lambda k, d, s, **gates: "lgen")
    X = torch.tensor(make_paths(rng, 2, 5, 2))
    with pytest.raises(TypeError, match="LinearKernel"):
        skt.sig_gram(skt.Linear_ID_Kernel(), X, X)
