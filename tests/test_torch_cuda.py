"""The port's CUDA kernels against their plain versions, on the card: the
forward kernels K1 and K2, their stack-emitting instances, the adjoint K3
(gen and inc sources), the increment-chain VJP K4 (bit for bit against its
emulation, run to run, at any dimension), the derivative Gram's
triple wavefront K5 (its band kernel, past the earlier row bound too), the
Linear generator K6, K1 and K1-stack at the edges of their band
decomposition and in launches split by the scratch bound,
K3<gen> on its band kernel at the edges of the band decomposition, with
and without the per-pair weights it folds in, and on its one-block kernel
past f = 32, the stripe kernels K7,
K7-stack and K3<inc, boundary> (its band kernel, and its one-block kernel
past f = 32), the sparse-checkpoint pair K2-sparse and
K8 (K8's band kernel at the edges of its decomposition, its one-block
kernel past f = 32), K2, K2-stack and K2-sparse on their band kernel at
its edges (bit for bit against their plain versions and emulations, run
to run, past the one-block row bound), values and gradients through the
estimators against the plain tier, the generator's lincomb with one
read of sigma on the host and none of the indices it builds, and K9 (the
RBF increment grids) bit for bit against its plain version, with the
scoring rule on K9 and K4 against the autograd route they replace, and K10
and K11 (the Linear increment grids and their VJP) against their plain
versions, with the Linear lincomb on them against the autograd route they
replace.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU mode); without one
they skip. On a GPU machine, run them without the JAX-side conftest:

    python -m pytest --noconftest -m requires_cuda tests/test_torch_cuda.py -q

This file imports torch and the port only, so it also runs where JAX is not
installed.
"""
import numpy as np
import pytest
import torch

import sigkernel_tpu_torch as skt
from sigkernel_tpu_torch.ops import (_build, band, cuda_blocked, cuda_deriv,
                                     cuda_gen, cuda_lgen, cuda_solver, incvjp,
                                     routes)
from sigkernel_tpu_torch.utils import double_difference

pytestmark = pytest.mark.requires_cuda

# f64: the parity bar of the port; f32: the kernels round in the plain
# versions' op order, exp aside
RTOL = {torch.float64: 1e-10, torch.float32: 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _paths(batch, length, dim, seed, device, dtype):
    rng = np.random.default_rng(seed)
    steps = rng.normal(size=(batch, length, dim)) * 0.5 / np.sqrt(length)
    return torch.tensor(np.cumsum(steps, axis=1), dtype=dtype, device=device)


def _rel(got, want):
    return float(((got - want).abs() / want.abs()).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("naive", [False, True])
@pytest.mark.parametrize("dyadic", [0, 1, 2])
@pytest.mark.parametrize("M,N", [(10, 20), (20, 10), (17, 17)])
def test_inc_kernel_matches_plain(cuda, dtype, naive, dyadic, M, N):
    X = _paths(4, M, 3, 0, cuda, dtype)
    Y = _paths(4, N, 3, 1, cuda, dtype)
    inc = double_difference(skt.RBFKernel(0.7).batch_kernel(X, Y)).contiguous()
    got = cuda_solver.inc_solve_final(inc, dyadic, naive)
    want = cuda_solver.inc_solve_final_plain(inc, dyadic, naive)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (4,)
    assert _rel(got, want) <= RTOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("naive", [False, True])
@pytest.mark.parametrize("dyadic", [0, 1, 2])
@pytest.mark.parametrize("M,N", [(10, 20), (20, 10), (17, 17)])
def test_gen_kernel_matches_plain(cuda, dtype, naive, dyadic, M, N):
    X = _paths(3, M, 2, 2, cuda, dtype)
    Y = _paths(4, N, 2, 3, cuda, dtype)
    ii = torch.tensor([0, 2, 1, 2, 0], device=cuda)
    jj = torch.tensor([3, 0, 1, 2, 2], device=cuda)
    got = cuda_gen.rbf_gen_solve_final(X, Y, ii, jj, 0.5, dyadic, naive)
    want = cuda_gen.rbf_gen_solve_final_plain(X, Y, ii, jj, 0.5, dyadic,
                                              naive)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (5,)
    assert _rel(got, want) <= RTOL[dtype]


def test_length_one_and_empty_launch_nothing(cuda):
    X = _paths(3, 1, 2, 4, cuda, torch.float64)
    Y = _paths(3, 6, 2, 5, cuda, torch.float64)
    ii = torch.arange(3, device=cuda)
    before = dict(cuda_gen.COUNTS), dict(cuda_solver.COUNTS)
    ones = cuda_gen.rbf_gen_solve_final(X, Y, ii, ii, 1.0, 1)
    assert torch.equal(ones, torch.ones(3, dtype=X.dtype, device=cuda))
    inc = torch.zeros(3, 0, 5, dtype=torch.float64, device=cuda)
    assert torch.equal(cuda_solver.inc_solve_final(inc, 1), ones)
    empty = torch.zeros(0, dtype=torch.int64, device=cuda)
    assert cuda_gen.rbf_gen_solve_final(Y, Y, empty, empty, 1.0).shape == (0,)
    assert (dict(cuda_gen.COUNTS), dict(cuda_solver.COUNTS)) == before


def test_launch_counters_count_launches(cuda):
    X = _paths(2, 8, 3, 6, cuda, torch.float32)
    ii = torch.arange(2, device=cuda)
    n_gen = cuda_gen.COUNTS["float32"]
    plain = cuda_gen.COUNTS["plain"]
    cuda_gen.rbf_gen_solve_final(X, X, ii, ii, 1.0)
    assert cuda_gen.COUNTS["float32"] == n_gen + 1
    assert cuda_gen.COUNTS["plain"] == plain
    inc = double_difference(skt.RBFKernel(1.0).batch_kernel(X, X)).contiguous()
    n_inc = cuda_solver.COUNTS["float32"]
    cuda_solver.inc_solve_final(inc)
    assert cuda_solver.COUNTS["float32"] == n_inc + 1


def test_shared_memory_bound_raises(cuda):
    """K3<inc>, one block a pair, keeps the row bound of its ring in shared
    memory; K2, on the band kernel since it has none, takes the grid."""
    rows = _build.SMEM_BYTES // (3 * 8)        # one row past the f64 bound
    inc = torch.zeros(1, rows // 4 + 1, rows // 4 + 1, dtype=torch.float64,
                      device=cuda)
    with pytest.raises(ValueError, match="shared"):
        cuda_solver.inc_adjoint(inc, torch.empty(0, device=cuda),
                                dyadic_order=2)
    assert torch.equal(cuda_solver.inc_solve_final(inc, dyadic_order=2),
                       torch.ones(1, dtype=torch.float64, device=cuda))


def test_wrapper_rejects_bad_inputs(cuda):
    inc = torch.zeros(2, 4, 4, dtype=torch.float16, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        cuda_solver.inc_solve_final(inc)
    inc = torch.zeros(2, 4, 8, dtype=torch.float64, device=cuda)[:, :, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        cuda_solver.inc_solve_final(inc)
    X = _paths(2, 5, 2, 7, cuda, torch.float64)
    bad = torch.tensor([0, 2], device=cuda)
    with pytest.raises(ValueError, match="range"):
        cuda_gen.rbf_gen_solve_final(X, X, bad, bad, 1.0)


@pytest.mark.parametrize("kernel", [skt.RBFKernel(0.5), skt.LinearKernel(0.8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_estimators_on_card_match_plain_tier(cuda, kernel, dtype):
    X = _paths(6, 12, 3, 8, cuda, dtype)
    Y = _paths(5, 9, 3, 9, cuda, dtype)
    for solver in ("auto", "cuda"):
        sig = skt.SigKernel(kernel, dyadic_order=1, solver=solver)
        plain = skt.SigKernel(kernel, dyadic_order=1, solver="scan")
        assert _rel(sig.compute_Gram(X, Y, max_batch=4),
                    plain.compute_Gram(X, Y)) <= RTOL[dtype]
        K = sig.compute_Gram(X, X, sym=True)
        assert torch.equal(K, K.T)
        assert _rel(K, plain.compute_Gram(X, X, sym=True)) <= RTOL[dtype]
        assert _rel(sig.compute_kernel(X[:5], Y),
                    plain.compute_kernel(X[:5], Y)) <= RTOL[dtype]
        mmd = sig.compute_mmd(X, Y, max_batch=3)
        assert abs(float(mmd - plain.compute_mmd(X, Y))) <= (
            10 * RTOL[dtype] * float(K.abs().max()))


# ---- the adjoint's kernels: K1-stack, K2-stack, K3<gen|inc>, K4 ----------

# gradients against their plain versions, max |err| / max |ref|: f64 the
# port's bar; f32 the order of the kernels' sums (K4) and the float32
# adjoint chain
GRAD_BAR = {torch.float64: 1e-10, torch.float32: 1e-4}


def _max_rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("naive", [False, True])
@pytest.mark.parametrize("dyadic", [0, 1, 2])
@pytest.mark.parametrize("M,N", [(10, 20), (20, 10), (17, 17)])
def test_adjoint_kernels_match_plain(cuda, dtype, naive, dyadic, M, N):
    X = _paths(3, M, 2, 10, cuda, dtype)
    Y = _paths(4, N, 2, 11, cuda, dtype)
    ii = torch.tensor([0, 2, 1, 2, 0], device=cuda)
    jj = torch.tensor([3, 0, 1, 2, 2], device=cuda)
    v, stack = cuda_gen.rbf_gen_solve_stack(X, Y, ii, jj, 0.5, dyadic, naive)
    pv, pstack = cuda_gen.rbf_gen_solve_stack_plain(X, Y, ii, jj, 0.5,
                                                    dyadic, naive)
    assert torch.equal(v, pv) and torch.equal(stack, pstack)
    assert torch.equal(v, cuda_gen.rbf_gen_solve_final(X, Y, ii, jj, 0.5,
                                                       dyadic, naive))
    ct = cuda_gen.rbf_gen_adjoint(X, Y, ii, jj, 0.5, stack, dyadic, naive)
    assert torch.equal(ct, cuda_gen.rbf_gen_adjoint_plain(
        X, Y, ii, jj, 0.5, pstack, dyadic, naive))
    got = incvjp.rbf_dd_vjp(X, Y, ii, jj, 0.5, ct)
    want = incvjp.rbf_dd_vjp_plain(X, Y, ii, jj, 0.5, ct)
    for g, w in zip(got, want):
        assert _max_rel(g, w) <= GRAD_BAR[dtype]
    inc = double_difference(skt.RBFKernel(0.5).batch_kernel(
        X[ii], Y[jj])).contiguous()
    v2, stack2 = cuda_solver.inc_solve_stack(inc, dyadic, naive)
    pv2, pstack2 = cuda_solver.inc_solve_stack_plain(inc, dyadic, naive)
    assert torch.equal(v2, pv2) and torch.equal(stack2, pstack2)
    assert torch.equal(cuda_solver.inc_adjoint(inc, stack2, dyadic, naive),
                       cuda_solver.inc_adjoint_plain(inc, pstack2, dyadic,
                                                     naive))


@pytest.mark.parametrize("grade", ["auto", "f32"])
@pytest.mark.parametrize("kernel", [skt.RBFKernel(0.5), skt.LinearKernel(0.8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gradients_on_card_match_plain_tier(cuda, kernel, dtype, grade):
    """Gram, triangle and lincomb gradients through the kernels against
    solver='scan' (the plain adjoint) on the card."""
    X0 = _paths(5, 12, 3, 12, cuda, dtype)
    Y0 = _paths(4, 9, 3, 13, cuda, dtype)
    W = torch.randn(5, 4, generator=torch.Generator().manual_seed(0),
                    dtype=dtype).to(cuda)
    bar = GRAD_BAR[dtype] if grade == "auto" else 1e-4
    grads = {}
    for solver in ("auto", "scan"):
        X, Y = X0.clone().requires_grad_(), Y0.clone().requires_grad_()
        k = type(kernel)(torch.tensor(0.6, dtype=dtype, device=cuda,
                                      requires_grad=True))
        S = (skt.sig_gram_lincomb(k, X, Y, W, dyadic_order=1, pair_chunk=7,
                                  solver=solver, grad_solver=grade)
             + (W * skt.sig_gram(k, X, Y, dyadic_order=1, max_batch=3,
                                 solver=solver, grad_solver=grade)).sum()
             + skt.sig_mmd(k, X, Y, dyadic_order=1, solver=solver,
                           grad_solver=grade))
        S.backward()
        hyper = next(iter(k.buffers()))
        grads[solver] = (X.grad, Y.grad, hyper.grad)
    for g, w in zip(grads["auto"], grads["scan"]):
        assert g.dtype == dtype and _max_rel(g, w) <= bar


def test_adjoint_launch_counters_count_launches(cuda):
    X = _paths(3, 8, 3, 14, cuda, torch.float64).requires_grad_()
    counters = (cuda_gen.STACK_COUNTS, cuda_gen.ADJOINT_COUNTS, incvjp.COUNTS)
    before = [dict(c) for c in counters]
    skt.sig_gram(skt.RBFKernel(1.0), X, X, sym=True).sum().backward()
    for c, b in zip(counters, before):
        assert c["float64"] > b["float64"] and c["plain"] == b["plain"]
    n_stack = cuda_solver.STACK_COUNTS["float64"]
    n_adj = cuda_solver.ADJOINT_COUNTS["float64"]
    X.grad = None
    skt.sig_gram(skt.LinearKernel(1.0), X, X).sum().backward()
    assert cuda_solver.STACK_COUNTS["float64"] == n_stack + 1
    assert cuda_solver.ADJOINT_COUNTS["float64"] == n_adj + 1


def test_length_one_gradients_are_zero_without_launches(cuda):
    X = _paths(2, 1, 2, 15, cuda, torch.float64).requires_grad_()
    Y = _paths(3, 6, 2, 16, cuda, torch.float64).requires_grad_()
    before = dict(cuda_gen.STACK_COUNTS)
    skt.sig_gram_lincomb(skt.RBFKernel(0.5), X, Y,
                         torch.ones(2, 3, dtype=X.dtype, device=cuda)
                         ).backward()
    assert not X.grad.any() and not Y.grad.any()
    assert dict(cuda_gen.STACK_COUNTS) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lincomb_reads_sigma_once_on_the_host(cuda, dtype, monkeypatch):
    """The north-star call at a small shape (6 x 5 paths of length 33, dim
    3, dyadic 1, 7 pairs a chunk: 5 chunks), fwd + bwd under the profiler,
    reads the card on the host once, sigma on the card requiring a gradient
    (one ``sk.sync.sigma`` span), and not at all with sigma held on the
    host; it reads no index bounds (a spy on the ops' host reads records
    each read's site). Its value and its
    gradients in X, Y and sigma are equal bit for bit either way, and agree
    with the plain tier."""
    from torch.profiler import ProfilerActivity, profile

    X0 = _paths(6, 33, 3, 30, cuda, dtype)
    Y0 = _paths(5, 33, 3, 31, cuda, dtype)
    W = torch.randn(6, 5, generator=torch.Generator().manual_seed(1),
                    dtype=dtype).to(cuda)

    def call(where, solver="auto"):
        X, Y = X0.clone().requires_grad_(), Y0.clone().requires_grad_()
        sigma = torch.tensor(0.6, dtype=torch.float64, device=where,
                             requires_grad=True)
        S = skt.sig_gram_lincomb(skt.RBFKernel(sigma), X, Y, W,
                                 dyadic_order=1, pair_chunk=7, solver=solver)
        S.backward()
        return S.detach(), X.grad, Y.grad, sigma.grad.to(cuda)

    sites, host = [], cuda_gen.host

    def spy(t, site):
        sites.append(site)
        return host(t, site)

    monkeypatch.setattr(cuda_gen, "host", spy)

    def traced(where):
        sites.clear()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = call(where)
            torch.cuda.synchronize()
        names = [e.name() for e in prof.profiler.kineto_results.events()]
        assert "sk.est.sig_gram_lincomb" in names
        assert "index_bounds" not in sites
        return out, [n for n in names if n.startswith("sk.sync.")]

    call(cuda)  # the library's build and the allocator's first blocks
    on_card, syncs = traced(cuda)
    assert syncs == ["sk.sync.sigma"]
    on_host, syncs = traced("cpu")
    assert syncs == []
    for a, b in zip(on_card, on_host):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for g, w in zip(on_card, call(cuda, "scan")):
        assert _max_rel(g, w) <= GRAD_BAR[dtype]


# ---- K4: one tiled pass, its sums in a fixed order ------------------------

# pairs, M, N, D: a short last band (64 rows) and two warps of columns, M >
# N, a second chunk of columns (1024), M = 2 and N = 2, D 1 to 8 in
# registers and the wide kernel past it (D 40; D 300 in double below)
_VJP_CASES = [(6, 7, 11, 2), (6, 70, 200, 3), (4, 130, 40, 1),
              (4, 40, 1100, 5), (6, 2, 90, 8), (6, 90, 2, 3), (3, 70, 300, 40)]


def _vjp_inputs(P, M, N, D, cuda, dtype, seed=20):
    """Paths, pair indices with repeats, and ct from the chain (K1-stack ->
    K3<gen>, dyadic 1)."""
    X = _paths(3, M, D, seed, cuda, dtype)
    Y = _paths(4, N, D, seed + 1, cuda, dtype)
    g = torch.Generator().manual_seed(seed)
    ii = torch.randint(0, 3, (P,), generator=g).to(cuda)
    jj = torch.randint(0, 4, (P,), generator=g).to(cuda)
    _, stack = cuda_gen.rbf_gen_solve_stack(X, Y, ii, jj, 0.5, 1)
    return X, Y, ii, jj, cuda_gen.rbf_gen_adjoint(X, Y, ii, jj, 0.5, stack, 1)


def _vjp_checks(X, Y, ii, jj, ct, dtype):
    got = incvjp.rbf_dd_vjp_pairs(X, Y, ii, jj, 0.5, ct)
    again = incvjp.rbf_dd_vjp_pairs(X, Y, ii, jj, 0.5, ct)
    want = incvjp.rbf_dd_vjp_pairs_tiled_plain(X, Y, ii, jj, 0.5, ct)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a) and torch.equal(g, w)
    full = incvjp.rbf_dd_vjp(X, Y, ii, jj, 0.5, ct)
    plain = incvjp.rbf_dd_vjp_plain(X, Y, ii, jj, 0.5, ct)
    for g, w in zip(full, plain):
        assert g.dtype == dtype and _max_rel(g, w) <= GRAD_BAR[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("P,M,N,D", _VJP_CASES)
def test_vjp_kernel_is_its_emulation(cuda, dtype, P, M, N, D):
    """K4 equals its emulation bit for bit, two launches equal each other,
    and the wrapper is within the gradient bar of the plain version."""
    _vjp_checks(*_vjp_inputs(P, M, N, D, cuda, dtype), dtype)


def test_vjp_kernel_takes_any_dimension(cuda):
    """D 300 in double (the earlier kernel refused D > 226)."""
    _vjp_checks(*_vjp_inputs(3, 40, 70, 300, cuda, torch.float64),
                torch.float64)


# ---- K5 (derivative Gram) and K6 (Linear generator) -----------------------

# K_diff and K_diffdiff, max |err| / max |ref|: the port's derivative bars
DERIV_BAR = {torch.float64: 1e-9, torch.float32: 1e-3}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dyadic", [0, 1, 2, 5, 6])
@pytest.mark.parametrize("Mb,Nb", [(9, 19), (19, 9), (16, 16), (1, 7),
                                   (130, 70), (33, 140)])
def test_deriv_kernel_matches_plain(cuda, dtype, dyadic, Mb, Nb):
    """K5's band kernel, bit for bit its plain version: one band to many
    (R up to 4,480 at dyadic 5 and 6), both frames, a short last band."""
    gen = torch.Generator().manual_seed(Mb * 100 + Nb + dyadic)
    grids = [(0.3 * torch.randn(5, Mb, Nb, generator=gen, dtype=torch.float64)
              ).to(dtype).to(cuda) for _ in range(3)]
    got = cuda_deriv.deriv_solve_final(*grids, dyadic)
    want = cuda_deriv.deriv_solve_final_plain(*grids, dyadic)
    torch.cuda.synchronize()
    assert all(g.dtype == dtype and g.shape == (5,) for g in got)
    assert _rel(got[0], want[0]) <= RTOL[dtype]
    for g, w in zip(got[1:], want[1:]):
        assert _max_rel(g, w) <= DERIV_BAR[dtype]
        assert torch.equal(g, w)
    assert torch.equal(got[0], want[0])


def test_deriv_kernel_has_no_row_bound_and_refuses(cuda):
    """Past the earlier one-block kernel's 4,840 rows (double) K5 runs its
    band kernel: zero grids give (1, 0, 0) at 8,184 rows; gradients are
    refused (forward only)."""
    past = torch.zeros(1, 1023, 1023, dtype=torch.float64, device=cuda)
    before = cuda_deriv.COUNTS["float64"]
    k, d, s = cuda_deriv.deriv_solve_final(past, past, past, dyadic_order=3)
    assert cuda_deriv.COUNTS["float64"] == before + 1
    assert (float(k), float(d), float(s)) == (1.0, 0.0, 0.0)  # zero grids
    x = _paths(2, 6, 2, 17, cuda, torch.float64).requires_grad_()
    with pytest.raises(ValueError, match="forward only"):
        skt.sig_kernel_and_derivatives_gram(skt.RBFKernel(0.5), x, x, x)


@pytest.mark.parametrize("kernel", [skt.RBFKernel(0.5), skt.LinearKernel(0.8),
                                    skt.RBF_SQR_Kernel(0.7, 1.4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_derivatives_gram_on_card_matches_plain_tier(cuda, kernel, dtype):
    X = _paths(5, 11, 3, 18, cuda, dtype)
    Y = _paths(4, 8, 3, 19, cuda, dtype)
    G = _paths(5, 11, 3, 20, cuda, dtype)
    before = cuda_deriv.COUNTS[str(dtype).removeprefix("torch.")]
    got = skt.SigKernel(kernel.to(cuda), dyadic_order=1
                        ).compute_kernel_and_derivatives_Gram(X, Y, G,
                                                              max_batch=3)
    assert cuda_deriv.COUNTS[str(dtype).removeprefix("torch.")] == before + 4
    want = skt.sig_kernel_and_derivatives_gram(kernel.to(cuda), X, Y, G,
                                               dyadic_order=1, solver="scan")
    assert _rel(got[0], want[0]) <= RTOL[dtype]
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == dtype and _max_rel(g, w) <= DERIV_BAR[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("naive", [False, True])
@pytest.mark.parametrize("dyadic", [0, 1, 2])
@pytest.mark.parametrize("M,N", [(10, 20), (20, 10), (17, 17), (1, 6)])
def test_linear_gen_kernel_matches_plain(cuda, dtype, naive, dyadic, M, N):
    X = _paths(3, M, 3, 21, cuda, dtype)
    Y = _paths(4, N, 3, 22, cuda, dtype)
    ii = torch.tensor([0, 2, 1, 2, 0], device=cuda)
    jj = torch.tensor([3, 0, 1, 2, 2], device=cuda)
    scale = torch.tensor(0.8, dtype=torch.float64, device=cuda)
    before = dict(cuda_lgen.COUNTS)
    got = cuda_lgen.linear_gen_solve_final(X, Y, ii, jj, scale, dyadic,
                                           naive)
    launched = cuda_lgen.COUNTS[str(dtype).removeprefix("torch.")] - before[
        str(dtype).removeprefix("torch.")]
    assert launched == (0 if M == 1 else 1)
    assert cuda_lgen.COUNTS["plain"] == before["plain"]
    want = cuda_lgen.linear_gen_solve_final_plain(X, Y, ii, jj, scale,
                                                  dyadic, naive)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (5,)
    assert _rel(got, want) <= RTOL[dtype]


# ---- long paths: K7, K7-stack, K3<inc, boundary>, K2-sparse, K8 -----------

def _grid(Mb, Nb, seed, device, dtype, P=3):
    gen = torch.Generator().manual_seed(seed)
    return (0.3 * torch.randn(P, Mb, Nb, generator=gen, dtype=torch.float64)
            ).to(dtype).to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("naive", [False, True])
@pytest.mark.parametrize("dyadic", [0, 1, 2])
@pytest.mark.parametrize("Mb,Nb", [(9, 14), (14, 9)])
def test_stripe_kernels_match_plain(cuda, dtype, naive, dyadic, Mb, Nb):
    """K7, K7-stack and K3<inc, boundary> against their plain versions,
    stripe by stripe (three stripes of 4 base rows, the last one short),
    and the whole stripe chain and striped adjoint against K2 and
    K2-stack -> K3<inc>, bit for bit."""
    inc = _grid(Mb, Nb, 30 + Mb + dyadic, cuda, dtype)
    f = 2 ** dyadic
    R, C = band.frame(Mb, Nb, dyadic)
    rows = 4 * f
    bd = torch.ones(3, C + 1, dtype=dtype, device=cuda)
    for row0 in range(0, R, rows):
        h = min(rows, R - row0)
        for flip in (False, True):
            got = cuda_blocked.stripe_solve(inc, bd, row0, h, dyadic, naive,
                                            flip)
            want = cuda_blocked.stripe_solve_plain(inc, bd, row0, h, dyadic,
                                                   naive, flip)
            assert torch.equal(got, want)
        b, stk = cuda_blocked.stripe_solve_stack(inc, bd, row0, h, dyadic,
                                                 naive)
        pb, pstk = cuda_blocked.stripe_solve_stack_plain(inc, bd, row0, h,
                                                         dyadic, naive)
        assert torch.equal(b, pb) and torch.equal(stk, pstk)
        ct = cuda_blocked.stripe_adjoint(inc, stk, bd, torch.zeros_like(inc),
                                         row0, h, dyadic, naive)
        pct = cuda_blocked.stripe_adjoint_plain(inc, stk, bd,
                                                torch.zeros_like(inc), row0,
                                                h, dyadic, naive)
        assert torch.equal(ct, pct)
        bd = b
    assert torch.equal(cuda_blocked.solve_final(inc, dyadic, naive, rows),
                       cuda_solver.inc_solve_final(inc, dyadic, naive))
    _, stack = cuda_solver.inc_solve_stack(inc, dyadic, naive)
    assert torch.equal(cuda_blocked.adjoint(inc, dyadic, naive, rows),
                       cuda_solver.inc_adjoint(inc, stack, dyadic, naive))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("P,Mb,Nb,dyadic,row0,rows", [
    (3, 70, 53, 2, 0, 200),     # ragged: two bands, a short last chunk
    (3, 70, 53, 2, 208, 280),   # zero-padded: bands wholly past the frame
    (1, 40, 59, 0, 0, 40),      # one pair, rows < 128
    (2, 150, 140, 0, 0, 140),   # a second band of 12 rows
    (2, 100, 90, 2, 4, 352),    # three bands, the ring lapped (C = 400)
])
def test_band_decomposition_matches_plain(cuda, dtype, flip, P, Mb, Nb,
                                          dyadic, row0, rows):
    """K7 and K7-stack at the edges of the band decomposition, bit for bit
    their plain versions and the CPU emulation of the decomposition."""
    inc = _grid(Mb, Nb, 50 + rows, cuda, dtype, P)
    C = max(Mb, Nb) * 2 ** dyadic
    bd = torch.ones(P, C + 1, dtype=dtype, device=cuda)
    bd[:, 1:] += 0.01 * torch.arange(C, dtype=dtype, device=cuda) / C
    got = cuda_blocked.stripe_solve(inc, bd, row0, rows, dyadic, False, flip)
    want = cuda_blocked.stripe_solve_plain(inc, bd, row0, rows, dyadic,
                                           False, flip)
    assert torch.equal(got, want)
    assert torch.equal(got, cuda_blocked.stripe_solve_banded_plain(
        inc, bd, row0, rows, dyadic, False, flip))
    b, stk = cuda_blocked.stripe_solve_stack(inc, bd, row0, rows, dyadic,
                                             False, flip)
    pb, pstk = cuda_blocked.stripe_solve_stack_plain(inc, bd, row0, rows,
                                                     dyadic, False, flip)
    assert torch.equal(b, pb) and torch.equal(stk, pstk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("naive", [False, True])
@pytest.mark.parametrize("P,Mb,Nb,dyadic,row0,rows", [
    (3, 70, 53, 2, 0, 200),     # ragged: two bands, a short last chunk
    (3, 70, 53, 2, 208, 280),   # zero-padded: bands wholly past the frame
    (1, 40, 59, 0, 0, 40),      # one pair, rows < 128
    (2, 150, 140, 0, 0, 140),   # a second band of 12 rows
    (2, 100, 90, 2, 4, 352),    # three bands, the ring lapped (C = 400)
    (3, 6, 8, 5, 0, 192),       # dyadic 5: a base row is a whole warp
    (3, 8, 6, 5, 128, 192),     # dyadic 5, transposed and zero-padded
    (2500, 63, 63, 2, 0, 252),  # 5,000 blocks, more than are resident
])
def test_band_adjoint_matches_plain(cuda, dtype, naive, P, Mb, Nb, dyadic,
                                    row0, rows):
    """K3<inc, boundary> on the band kernel at the edges of the band
    decomposition, bit for bit its plain version and the CPU emulation of
    the decomposition, adding into a cotangent that holds values."""
    inc = _grid(Mb, Nb, 60 + rows, cuda, dtype, P)
    C = max(Mb, Nb) * 2 ** dyadic
    bd = torch.ones(P, C + 1, dtype=dtype, device=cuda)
    bd[:, 1:] += 0.01 * torch.arange(C, dtype=dtype, device=cuda) / C
    _, stk = cuda_blocked.stripe_solve_stack(inc, bd.flip(-1).contiguous(),
                                             row0, rows, dyadic, naive)
    ct = _grid(Mb, Nb, 70 + rows, cuda, dtype, P)
    before = dict(cuda_blocked.ADJOINT_COUNTS)
    got = cuda_blocked.stripe_adjoint(inc, stk, bd, ct.clone(), row0, rows,
                                      dyadic, naive)
    key = str(dtype).removeprefix("torch.")
    assert {k: v - before[k] for k, v in cuda_blocked.ADJOINT_COUNTS.items()
            } == {k: int(k == key) for k in before}
    assert torch.equal(got, cuda_blocked.stripe_adjoint_plain(
        inc, stk, bd, ct.clone(), row0, rows, dyadic, naive))
    assert torch.equal(got, cuda_blocked.stripe_adjoint_banded_plain(
        inc, stk, bd, ct.clone(), row0, rows, dyadic, naive))


# K1 on the band kernel: pairs, path lengths M, N, dim, dyadic order. The
# frame's rows R = (min(M, N) - 1) 2^dyadic: 1, 31, 32, 33, 128 (one full
# band) and 129 (a second band of one row); a transposed pair (M > N); D = 1
# and 5 and D = 7 (no instance of its own: the points read through __ldg);
# dyadic 0-3; 3,000 pairs, more blocks than are resident; and the UEA
# selection cell's shapes at f = 1 on the generic instance: 144 points of
# 10 channels (add-time) and 287 of 19 (add-time and lead-lag), 143 and 286
# rows, a transposed pair of the two lengths, 2,000 pairs
_GEN_BAND = [
    (3, 2, 6, 2, 0), (3, 32, 40, 3, 0), (3, 33, 40, 1, 0), (2, 34, 50, 5, 0),
    (2, 65, 70, 3, 1), (2, 130, 140, 3, 0), (2, 70, 40, 3, 1),
    (2, 9, 12, 7, 3), (2, 17, 20, 5, 2), (3000, 17, 17, 3, 2),
    (3, 144, 144, 10, 0), (3, 287, 287, 19, 0), (3, 287, 144, 19, 0),
    (2000, 287, 287, 19, 0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("P,M,N,D,dyadic", _GEN_BAND)
def test_band_gen_matches_plain(cuda, dtype, P, M, N, D, dyadic):
    """K1 and K1-stack at the edges of the band decomposition, bit for bit
    their plain versions (and, at a few pairs, the CPU emulation of the
    band kernel)."""
    A = max(P // 2, 2)
    X = _paths(A, M, D, 90 + M, cuda, dtype)
    Y = _paths(A, N, D, 91 + N, cuda, dtype)
    g = torch.Generator(device=cuda).manual_seed(P + M)
    ii = torch.randint(0, A, (P,), generator=g, device=cuda)
    jj = torch.randint(0, A, (P,), generator=g, device=cuda)
    for naive in (False, True):
        got = cuda_gen.rbf_gen_solve_final(X, Y, ii, jj, 0.8, dyadic, naive)
        want = cuda_gen.rbf_gen_solve_final_plain(X, Y, ii, jj, 0.8, dyadic,
                                                  naive)
        assert torch.equal(got, want)
        v, stk = cuda_gen.rbf_gen_solve_stack(X, Y, ii, jj, 0.8, dyadic,
                                              naive)
        pv, pstk = cuda_gen.rbf_gen_solve_stack_plain(X, Y, ii, jj, 0.8,
                                                      dyadic, naive)
        assert torch.equal(v, got) and torch.equal(pv, want)
        assert torch.equal(stk, pstk)
        if P <= 3:
            assert torch.equal(got, cuda_gen.rbf_gen_banded_plain(
                X, Y, ii, jj, 0.8, dyadic, naive))


def test_band_fill_counts_each_band_launch(cuda):
    """``cuda_gen.BAND_FILL`` after one K1 launch of 5 pairs of 287 points
    (286 rows in 3 bands of 128) and one K2 launch of 5 grids of 143 rows
    (2 bands)."""
    X = _paths(4, 287, 19, 7, cuda, torch.float64)
    ii = torch.tensor([0, 1, 2, 3, 0], device=cuda)
    jj = torch.tensor([3, 2, 1, 0, 0], device=cuda)
    before = dict(cuda_gen.BAND_FILL)
    n = cuda_gen.COUNTS["float64"]
    cuda_gen.rbf_gen_solve_final(X, X, ii, jj, 1.0)
    assert cuda_gen.COUNTS["float64"] == n + 1
    assert cuda_gen.BAND_FILL == {"rows": before["rows"] + 5 * 286,
                                  "slots": before["slots"] + 5 * 3 * 128}
    inc = torch.rand(5, 143, 200, dtype=torch.float64, device=cuda) * 1e-3
    cuda_solver.inc_solve_final(inc, 0)
    assert cuda_gen.BAND_FILL == {
        "rows": before["rows"] + 5 * 286 + 5 * 143,
        "slots": before["slots"] + 5 * 3 * 128 + 5 * 2 * 128}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gram_tiles_are_the_untiled_pairs(cuda, dtype):
    """``sig_gram`` of 300 x 275 paths of the UEA cell's add-time shape in
    ``max_batch`` 100 tiles (nine, three of them 100 x 75) is bit for bit
    K1 on the 82,500 pairs in one call; the ``sym`` triangle of the 275
    likewise, and exactly symmetric."""
    X = _paths(300, 144, 10, 11, cuda, dtype)
    Y = _paths(275, 144, 10, 12, cuda, dtype)
    k = skt.RBFKernel(0.25)
    G = skt.sig_gram(k, X, Y, max_batch=100)
    ii = torch.arange(300, device=cuda).repeat_interleave(275)
    jj = torch.arange(275, device=cuda).repeat(300)
    want = cuda_gen.rbf_gen_solve_final(X, Y, ii, jj, 0.25)
    assert torch.equal(G, want.reshape(300, 275))
    S = skt.sig_gram(k, Y, Y, sym=True, max_batch=100)
    iu, ju = torch.triu_indices(275, 275, device=cuda)
    assert torch.equal(S[iu, ju], cuda_gen.rbf_gen_solve_final(Y, Y, iu, ju,
                                                               0.25))
    assert torch.equal(S, S.T)


def test_svc_grams_on_card_match_plain_tier_without_sigma_reads(cuda):
    """``transform`` and ``SigKernelSVC``'s Grams on the card at the UEA
    cell's lengths (add-time and lead-lag: 287 points of 19 channels), in
    ragged tiles, against the same on the CPU's plain tier; sigma given as
    a number is never read from the device."""
    from torch.profiler import ProfilerActivity, profile

    from sigkernel_tpu_torch.models import SigKernelSVC

    X = _paths(7, 144, 9, 13, cuda, torch.float64)
    T = _paths(5, 144, 9, 14, cuda, torch.float64)
    got = {}
    for dev in (cuda, torch.device("cpu")):
        x = skt.transform(X.to(dev), at=True, ll=True, scale=0.1)
        t = skt.transform(T.to(dev), at=True, ll=True, scale=0.1)
        assert x.shape == (7, 287, 19) and x.device.type == dev.type
        svc = SigKernelSVC(skt.RBFKernel(0.1), 0, max_batch=3)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            got[dev.type] = (svc.train_gram(x), svc.test_gram(t))
        names = [e.name() for e in prof.profiler.kineto_results.events()]
        assert "sk.sync.sigma" not in names
    for a, b in zip(got["cuda"], got["cpu"]):
        assert _rel(a.cpu(), b) <= RTOL[torch.float64]


def test_band_gen_splits_its_launches_by_the_scratch_bound(cuda, monkeypatch):
    """With the scratch bound cut to one pair's hand-off rows, K1 and
    K1-stack launch once a pair, with the same values and stack."""
    X = _paths(4, 140, 3, 95, cuda, torch.float64)  # R = 139: two bands
    ii = torch.tensor([0, 1, 2, 3, 0], device=cuda)
    jj = torch.tensor([3, 2, 1, 0, 0], device=cuda)
    whole = cuda_gen.rbf_gen_solve_final(X, X, ii, jj, 1.0)
    _, whole_stack = cuda_gen.rbf_gen_solve_stack(X, X, ii, jj, 1.0)
    monkeypatch.setattr(band, "SCRATCH_BYTES", 140 * 8)
    n, n_stack = cuda_gen.COUNTS["float64"], cuda_gen.STACK_COUNTS["float64"]
    assert torch.equal(cuda_gen.rbf_gen_solve_final(X, X, ii, jj, 1.0), whole)
    v, stk = cuda_gen.rbf_gen_solve_stack(X, X, ii, jj, 1.0)
    assert torch.equal(v, whole) and torch.equal(stk, whole_stack)
    assert cuda_gen.COUNTS["float64"] == n + 5
    assert cuda_gen.STACK_COUNTS["float64"] == n_stack + 5


# K3<gen> on the band kernel: pairs, M, N, D, dyadic; the cases of
# tests/test_torch_band_gen_adjoint.py (R 1, 31, 32, 33, 128 and 129, M <, ==
# and > N, D 1, 3 and 5, dyadic 0-3 and 5), then D 7 (the generic source),
# a frame of 1,020 rows (8 bands) and 3,000 pairs, more blocks than are
# resident
_GEN_ADJOINT_BAND = [
    (3, 2, 6, 1, 0), (3, 32, 40, 3, 0), (4, 33, 35, 1, 0), (3, 34, 36, 5, 0),
    (3, 65, 70, 3, 1), (3, 130, 132, 3, 0), (4, 6, 6, 3, 2), (3, 9, 5, 5, 1),
    (4, 11, 6, 1, 2), (3, 4, 7, 5, 3), (3, 6, 4, 3, 3), (3, 3, 4, 3, 5),
    (4, 4, 3, 1, 5), (2, 9, 12, 7, 3), (2, 256, 300, 3, 2),
    (3000, 17, 17, 3, 2),
]


def _gen_pairs(P, M, N, D, cuda, dtype):
    A = max(P // 2, 2)
    X = _paths(A, M, D, 80 + M, cuda, dtype)
    Y = _paths(A, N, D, 81 + N, cuda, dtype)
    g = torch.Generator(device=cuda).manual_seed(P + N)
    ii = torch.randint(0, A, (P,), generator=g, device=cuda)
    jj = torch.randint(0, A, (P,), generator=g, device=cuda)
    return X, Y, ii, jj


def _launched(counts, before):
    return {k: v - before[k] for k, v in counts.items()}


def test_band_gen_adjoint_matches_plain(cuda):
    """K3<gen> on the band kernel at the edges of its band decomposition,
    both dtypes and schemes: one launch under the dtype's key, bit for bit
    its plain version on K1-stack's stack (and, at a few pairs, the CPU
    emulation of the band kernel)."""
    for dtype in (torch.float32, torch.float64):
        key = str(dtype).removeprefix("torch.")
        for P, M, N, D, dyadic in _GEN_ADJOINT_BAND:
            X, Y, ii, jj = _gen_pairs(P, M, N, D, cuda, dtype)
            for naive in (False, True):
                _, stk = cuda_gen.rbf_gen_solve_stack(X, Y, ii, jj, 0.8,
                                                      dyadic, naive)
                before = dict(cuda_gen.ADJOINT_COUNTS)
                got = cuda_gen.rbf_gen_adjoint(X, Y, ii, jj, 0.8, stk, dyadic,
                                               naive)
                assert _launched(cuda_gen.ADJOINT_COUNTS, before) == {
                    k: int(k == key) for k in before}
                assert got.shape == (P, M - 1, N - 1)
                assert torch.equal(got, cuda_gen.rbf_gen_adjoint_plain(
                    X, Y, ii, jj, 0.8, stk, dyadic, naive))
                if P <= 4 and max(M, N) < 200:
                    assert torch.equal(
                        got, cuda_gen.rbf_gen_adjoint_banded_plain(
                            X, Y, ii, jj, 0.8, stk, dyadic, naive))


def test_gen_adjoint_at_dyadic_6_takes_the_one_block_kernel(cuda):
    """f = 64 > 32: K3<gen> launches its one-block kernel (its own counter,
    no dtype key), bit for bit its plain version, in both frames."""
    for dtype in (torch.float32, torch.float64):
        for M, N in ((4, 3), (3, 5)):
            X, Y, ii, jj = _gen_pairs(3, M, N, 3, cuda, dtype)
            _, stk = cuda_gen.rbf_gen_solve_stack(X, Y, ii, jj, 0.8, 6)
            before = dict(cuda_gen.ADJOINT_COUNTS)
            got = cuda_gen.rbf_gen_adjoint(X, Y, ii, jj, 0.8, stk, 6)
            assert _launched(cuda_gen.ADJOINT_COUNTS, before) == {
                k: int(k == "one_block") for k in before}
            assert torch.equal(got, cuda_gen.rbf_gen_adjoint_plain(
                X, Y, ii, jj, 0.8, stk, 6))


def test_band_gen_adjoint_splits_its_launches_by_the_scratch_bound(
        cuda, monkeypatch):
    """With the scratch bound cut to one pair's hand-off rows, K3<gen>
    launches once a pair, with the same cotangent."""
    X = _paths(4, 140, 3, 96, cuda, torch.float64)  # R = 139: two bands
    Y = _paths(4, 150, 3, 97, cuda, torch.float64)
    ii = torch.tensor([0, 1, 2, 3, 0], device=cuda)
    jj = torch.tensor([3, 2, 1, 0, 0], device=cuda)
    _, stk = cuda_gen.rbf_gen_solve_stack(Y, X, jj, ii, 1.0)
    whole = cuda_gen.rbf_gen_adjoint(Y, X, jj, ii, 1.0, stk)
    monkeypatch.setattr(band, "SCRATCH_BYTES", 150 * 8)
    n = cuda_gen.ADJOINT_COUNTS["float64"]
    assert torch.equal(cuda_gen.rbf_gen_adjoint(Y, X, jj, ii, 1.0, stk),
                       whole)
    assert cuda_gen.ADJOINT_COUNTS["float64"] == n + 5


# (P, M, N, D, dyadic): f 1, 2, 4 and 32; M < N, M == N and M > N
_GEN_FOLD = [(5, 20, 30, 3, 0), (6, 17, 17, 2, 1), (4, 30, 12, 3, 2),
             (3, 5, 6, 1, 5), (3, 6, 5, 3, 5), (3, 7, 7, 2, 5)]


def _fold_weights(P, dtype, device):
    """Per-pair weights with zeros of both signs, negatives and
    subnormals."""
    tiny = torch.finfo(dtype).tiny / 8
    w = torch.tensor([-tiny, 0.0, 0.75, -1.25, -0.0, 3.0, tiny, 1e3],
                     dtype=dtype, device=device)
    return w[torch.arange(P, device=device) % w.shape[0]]


def _poisoned_adjoint(shape, dtype, device, fn):
    """``fn()`` right after a NaN-filled block of the cotangent's size was
    freed, so that its ``torch.empty`` hands back NaNs wherever the kernel
    leaves a cell unwritten."""
    poison = torch.full(shape, float("nan"), dtype=dtype, device=device)
    del poison
    return fn()


def test_band_gen_adjoint_folds_the_weights(cuda, monkeypatch):
    """K3<gen>'s band kernel stores each base cell finished (times 1 / f^2
    and the pair's weight) into an uninitialised cotangent: with and
    without ``g``, both dtypes and schemes, bit for bit its plain version
    and the unweighted cotangent times ``g``, no NaN left from the poisoned
    allocator, one ``band`` count a call; and in launches split by the
    scratch bound (the weights' pointer a pair further on each launch) the
    same cotangent as one launch. Past f = 32 the one-block kernel, weighted
    after it (``one_block``), equals its plain version too."""
    zero = dict.fromkeys(cuda_gen.ADJOINT_COUNTS, 0)
    for dtype in (torch.float32, torch.float64):
        for P, M, N, D, dyadic in _GEN_FOLD:
            X, Y, ii, jj = _gen_pairs(P, M, N, D, cuda, dtype)
            g = _fold_weights(P, dtype, cuda)
            for naive in (False, True):
                _, stk = cuda_gen.rbf_gen_solve_stack(X, Y, ii, jj, 0.8,
                                                      dyadic, naive)
                before = dict(cuda_gen.ADJOINT_COUNTS)
                plain = _poisoned_adjoint(
                    (P, M - 1, N - 1), dtype, cuda,
                    lambda: cuda_gen.rbf_gen_adjoint(X, Y, ii, jj, 0.8, stk,
                                                     dyadic, naive))
                got = _poisoned_adjoint(
                    (P, M - 1, N - 1), dtype, cuda,
                    lambda: cuda_gen.rbf_gen_adjoint(X, Y, ii, jj, 0.8, stk,
                                                     dyadic, naive, g=g))
                key = str(dtype).removeprefix("torch.")
                assert _launched(cuda_gen.ADJOINT_COUNTS, before) == {
                    **zero, key: 2}
                assert not (plain.isnan().any() or got.isnan().any())
                assert torch.equal(plain, cuda_gen.rbf_gen_adjoint_plain(
                    X, Y, ii, jj, 0.8, stk, dyadic, naive))
                assert torch.equal(got, cuda_gen.rbf_gen_adjoint_plain(
                    X, Y, ii, jj, 0.8, stk, dyadic, naive, g))
                assert torch.equal(got, plain * g[:, None, None])
    X = _paths(4, 140, 3, 96, cuda, torch.float64)  # R = 139: two bands
    Y = _paths(4, 150, 3, 97, cuda, torch.float64)
    ii = torch.tensor([0, 1, 2, 3, 0], device=cuda)
    jj = torch.tensor([3, 2, 1, 0, 0], device=cuda)
    g = _fold_weights(5, torch.float64, cuda).flip(0)
    _, stk = cuda_gen.rbf_gen_solve_stack(Y, X, jj, ii, 1.0)
    whole = cuda_gen.rbf_gen_adjoint(Y, X, jj, ii, 1.0, stk, g=g)
    assert torch.equal(whole, cuda_gen.rbf_gen_adjoint_plain(
        Y, X, jj, ii, 1.0, stk, g=g))
    monkeypatch.setattr(band, "SCRATCH_BYTES", 150 * 8)
    n = cuda_gen.ADJOINT_COUNTS["float64"]
    split = _poisoned_adjoint(
        whole.shape, torch.float64, cuda,
        lambda: cuda_gen.rbf_gen_adjoint(Y, X, jj, ii, 1.0, stk, g=g))
    assert cuda_gen.ADJOINT_COUNTS["float64"] == n + 5
    assert torch.equal(split, whole)
    # f = 64: the one-block kernel, its division and weighting in PyTorch
    X, Y, ii, jj = _gen_pairs(3, 4, 3, 3, cuda, torch.float64)
    g = _fold_weights(3, torch.float64, cuda)
    _, stk = cuda_gen.rbf_gen_solve_stack(X, Y, ii, jj, 0.8, 6)
    before = dict(cuda_gen.ADJOINT_COUNTS)
    got = cuda_gen.rbf_gen_adjoint(X, Y, ii, jj, 0.8, stk, 6, g=g)
    assert _launched(cuda_gen.ADJOINT_COUNTS, before) == {
        **zero, "one_block": 1}
    assert torch.equal(got, cuda_gen.rbf_gen_adjoint_plain(
        X, Y, ii, jj, 0.8, stk, 6, g=g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dyadic_6_takes_the_one_block_adjoint(cuda, dtype):
    """f = 64 > 32: K3<inc, boundary> launches the one-block kernel (its
    own counter), bit for bit its plain version."""
    inc = _grid(4, 3, 80, cuda, dtype, 2)
    C = 4 * 64
    bd = torch.ones(2, C + 1, dtype=dtype, device=cuda)
    bd[:, 1:] += 0.01 * torch.arange(C, dtype=dtype, device=cuda) / C
    _, stk = cuda_blocked.stripe_solve_stack(inc, bd, 0, 192, 6)
    before = dict(cuda_blocked.ADJOINT_COUNTS)
    got = cuda_blocked.stripe_adjoint(inc, stk, bd, torch.zeros_like(inc), 0,
                                      192, 6)
    assert {k: v - before[k] for k, v in cuda_blocked.ADJOINT_COUNTS.items()
            } == {k: int(k == "one_block") for k in before}
    assert torch.equal(got, cuda_blocked.stripe_adjoint_plain(
        inc, stk, bd, torch.zeros_like(inc), 0, 192, 6))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("naive", [False, True])
@pytest.mark.parametrize("dyadic", [0, 1, 2])
@pytest.mark.parametrize("W", [2, 5, cuda_solver.CKPT_WINDOW])
@pytest.mark.parametrize("Mb,Nb", [(9, 14), (14, 9), (1, 4)])
def test_ckpt_kernels_match_plain(cuda, monkeypatch, dtype, naive, dyadic, W,
                                  Mb, Nb):
    """K2-sparse against its plain version; K8 against K3<inc> on the full
    stack (the recompute rounds as the forward did) and its plain
    version, bit for bit."""
    monkeypatch.setattr(cuda_solver, "CKPT_WINDOW", W)
    inc = _grid(Mb, Nb, 40 + Nb + dyadic, cuda, dtype)
    v, sparse = cuda_solver.inc_solve_sparse(inc, dyadic, naive)
    pv, psparse = cuda_solver.inc_solve_sparse_plain(inc, dyadic, naive)
    assert torch.equal(v, pv) and torch.equal(sparse, psparse)
    assert torch.equal(v, cuda_solver.inc_solve_final(inc, dyadic, naive))
    ct = cuda_solver.inc_adjoint_ckpt(inc, sparse, dyadic, naive)
    _, stack = cuda_solver.inc_solve_stack(inc, dyadic, naive)
    assert torch.equal(ct, cuda_solver.inc_adjoint(inc, stack, dyadic, naive))
    assert torch.equal(ct, cuda_solver.inc_adjoint_ckpt_plain(
        inc, sparse, dyadic, naive))


# K8 at the edges of its band decomposition (tests/test_torch_band_ckpt.py
# emulates the same): (pairs, Mb, Nb, dyadic, W). Frames smaller than a
# window, transposed grids, no diagonal recomputed (W 2), a warp whose halo
# reaches row 0 (R 36), a short last warp and band (R 40, 70, 130: two bands
# the second of 2 rows), dyadic 2 and 5, a tall transposed grid (R 598, five
# bands), more blocks than the card holds at once (600 pairs x 2 bands), and
# dyadic 6, where the one-block kernel runs
CKPT_BAND_CASES = [
    (2, 2, 3, 0, 8), (2, 3, 2, 0, 3), (3, 9, 14, 1, 8), (3, 14, 9, 1, 3),
    (2, 10, 25, 0, 2), (2, 36, 45, 0, 8), (2, 40, 50, 0, 8),
    (2, 33, 40, 0, 3), (2, 17, 12, 2, 8), (2, 70, 75, 0, 8),
    (2, 130, 140, 0, 8), (2, 2, 3, 5, 8), (2, 3, 2, 5, 3),
    (2, 400, 300, 1, 5), (600, 65, 70, 2, 8), (2, 2, 3, 6, 8),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_band_ckpt_matches_plain(cuda, monkeypatch, dtype):
    """K8 at ``CKPT_BAND_CASES``, both schemes: one launch of the band
    kernel under the dtype's key (of the one-block kernel under
    ``"one_block"`` at dyadic 6), bit for bit its plain version, K3<inc> on
    the full stack, and at a few pairs the CPU emulation of the band
    kernel."""
    key = str(dtype).removeprefix("torch.")
    for P, Mb, Nb, dyadic, W in CKPT_BAND_CASES:
        monkeypatch.setattr(cuda_solver, "CKPT_WINDOW", W)
        X = _paths(P, Mb + 1, 3, 60 + Mb + dyadic, cuda, dtype)
        Y = _paths(P, Nb + 1, 3, 61 + Nb, cuda, dtype)
        inc = double_difference(skt.RBFKernel(0.5).batch_kernel(
            X, Y)).contiguous()
        want_key = ("one_block" if cuda_solver.ckpt_kernel(dyadic, W)
                    == "one_block" else key)
        for naive in (False, True):
            _, sparse = cuda_solver.inc_solve_sparse(inc, dyadic, naive)
            before = dict(cuda_solver.CKPT_COUNTS)
            got = cuda_solver.inc_adjoint_ckpt(inc, sparse, dyadic, naive)
            assert _launched(cuda_solver.CKPT_COUNTS, before) == {
                k: int(k == want_key) for k in before}
            assert torch.equal(got, cuda_solver.inc_adjoint_ckpt_plain(
                inc, sparse, dyadic, naive))
            _, stack = cuda_solver.inc_solve_stack(inc, dyadic, naive)
            assert torch.equal(got, cuda_solver.inc_adjoint(
                inc, stack, dyadic, naive))
            del stack
            if P <= 3 and max(Mb, Nb) * 2 ** dyadic < 200 and dyadic < 6:
                assert torch.equal(got, cuda_solver.
                                   inc_adjoint_ckpt_banded_plain(
                                       inc, sparse, dyadic, naive))


@pytest.mark.parametrize("tier", ["stripes", "ckpt"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_long_path_routes_on_card_match_plain_tier(cuda, monkeypatch, tier,
                                                   dtype):
    """Values and gradients of the estimators on the stripe routes (the row
    bound patched down to 12 rows) and on the sparse-checkpoint route (both
    gates' pair counts patched up) against solver='scan'."""
    if tier == "stripes":
        monkeypatch.setattr(_build, "max_rows", lambda itemsize: 12)
        counts = [cuda_blocked.COUNTS, cuda_blocked.STACK_COUNTS,
                  cuda_blocked.ADJOINT_COUNTS]
    else:
        monkeypatch.setattr(routes, "CKPT_MIN_PAIRS", 1 << 40)
        monkeypatch.setattr(routes, "GEN_CKPT_MIN_PAIRS", 1 << 40)
        counts = [cuda_solver.SPARSE_COUNTS, cuda_solver.CKPT_COUNTS]
    key = str(dtype).removeprefix("torch.")
    before = [c[key] for c in counts]
    X0 = _paths(4, 12, 3, 23, cuda, dtype)
    Y0 = _paths(3, 9, 3, 24, cuda, dtype)
    grads, vals = {}, {}
    for solver in ("auto", "scan"):
        X, Y = X0.clone().requires_grad_(), Y0.clone().requires_grad_()
        s = torch.tensor(0.6, dtype=dtype, device=cuda, requires_grad=True)
        k = skt.RBFKernel(s)
        vals[solver] = skt.sig_gram(k, X, Y, dyadic_order=1,
                                    solver=solver).detach()
        S = (skt.sig_mmd(k, X, Y, dyadic_order=1, solver=solver)
             + skt.sig_mmd(k, X, Y, dyadic_order=1, solver=solver,
                           max_batch=2, pair_chunk=5))
        S.backward()
        grads[solver] = (X.grad, Y.grad, s.grad)
    assert all(c[key] > b for c, b in zip(counts, before))
    assert _rel(vals["auto"], vals["scan"]) <= RTOL[dtype]
    for g, w in zip(grads["auto"], grads["scan"]):
        assert g.dtype == dtype and _max_rel(g, w) <= GRAD_BAR[dtype]


def test_long_path_routes_resolve_by_shape(cuda):
    """The row bound and the ckpt gate in both dtypes, as the card's
    routes read them."""
    past = 2 * _build.max_rows(4)
    assert routes.resolve_inc_tier((past, past), 8) == "stripes"
    assert routes.resolve_inc_tier((past, past), 8, backward=True) == (
        "striped")
    assert routes.resolve_inc_tier((4092, 4092), 8, backward=True) == "ckpt"
    assert routes.resolve_family(skt.RBFKernel(1.0), "cuda", "auto",
                                 shape=(4092, 4092), need_grad=True) == "inc"
    assert routes.resolve_family(skt.RBFKernel(1.0), "cuda", "auto",
                                 shape=(2892, 2892), need_grad=True) == "gen"
    assert routes.resolve_inc_tier((2046, 2046), 8, backward=True) == "full"
    assert routes.resolve_family(skt.RBFKernel(1.0), "cuda", "auto",
                                 shape=(past, past)) == "inc"


# K2, K2-stack and K2-sparse on the band kernel (tests/test_torch_band_inc.py
# emulates them): (pairs, Mb, Nb, dyadic, W). Frames of fewer than 32 rows,
# transposed grids, a second band (R 130), R 37 against C 301, dyadic 3 and
# 6 (f 64: the band modes read f at run time), W 2, 3 and 8, and more
# blocks than the card holds at once (3,000 pairs)
INC_BAND_CASES = [
    (3, 5, 7, 1, 8), (3, 37, 20, 0, 3), (2, 130, 140, 0, 2),
    (2, 37, 301, 0, 8), (3, 9, 12, 3, 3), (2, 3, 4, 6, 8), (2, 1, 40, 0, 2),
    (3000, 16, 16, 2, 8),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("naive", [False, True])
@pytest.mark.parametrize("P,Mb,Nb,dyadic,W", INC_BAND_CASES)
def test_band_inc_matches_plain_and_emulation(cuda, monkeypatch, dtype, naive,
                                              P, Mb, Nb, dyadic, W):
    """Each K2 instance bit for bit its plain version and its emulation,
    and two launches bit-identical."""
    monkeypatch.setattr(cuda_solver, "CKPT_WINDOW", W)
    inc = _grid(Mb, Nb, 60 + Mb + dyadic, cuda, dtype, P)
    runs = [(cuda_solver.inc_solve_final, cuda_solver.inc_solve_final_plain,
             cuda_solver.inc_solve_final_banded_plain),
            (cuda_solver.inc_solve_stack, cuda_solver.inc_solve_stack_plain,
             cuda_solver.inc_solve_stack_banded_plain),
            (cuda_solver.inc_solve_sparse, cuda_solver.inc_solve_sparse_plain,
             cuda_solver.inc_solve_sparse_banded_plain)]
    for kernel, plain, banded in runs:
        got, again = (kernel(inc, dyadic, naive) for _ in range(2))
        want = [plain(inc, dyadic, naive)]
        if P < 100:
            want.append(banded(inc, dyadic, naive))
        for w in want + [again]:
            for g, v in zip(*(t if isinstance(t, tuple) else (t,)
                              for t in (got, w))):
                assert g.shape == v.shape and torch.equal(g, v)


def test_band_inc_takes_rows_past_the_one_block_bound(cuda):
    """K2 in float on a frame past the one-block row bound (19,376 rows
    against 19,369), bit for bit its plain version."""
    X = _paths(1, 4845, 2, 70, cuda, torch.float32)
    Y = _paths(1, 4846, 2, 71, cuda, torch.float32)
    inc = double_difference(skt.RBFKernel(0.7).batch_kernel(X, Y)).contiguous()
    assert min(inc.shape[1:]) * 4 > _build.max_rows(4)
    got = cuda_solver.inc_solve_final(inc, 2)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, cuda_solver.inc_solve_final_plain(inc, 2))


# ---- K9: the RBF increment grids of the inc family's gradient route --------

# pairs, M, N, D: the scoring cell's shape (1024 x 1024, D 5); M < N and M >
# N with a short last band (64 rows) and a short last chunk of columns (512);
# D 1; D 9 and 13, past the register instances (any D through __ldg); M = 2
# and N = 2; a warp's span cut mid-way (N - 1 = 1100)
_INCREMENT_CASES = [(4, 1024, 1024, 5), (6, 70, 200, 3), (6, 200, 70, 3),
                    (5, 134, 600, 1), (4, 90, 40, 9), (3, 40, 130, 13),
                    (6, 2, 90, 5), (6, 90, 2, 8), (3, 66, 1101, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("P,M,N,D", _INCREMENT_CASES)
def test_increments_kernel_is_its_plain_version(cuda, dtype, P, M, N, D):
    """K9 equals its plain version (``gen_increments`` of the gathered
    pairs) bit for bit, with repeated pair indices, and two launches equal
    each other; one launch a call."""
    X = _paths(3, M, D, 80 + D, cuda, dtype)
    Y = _paths(4, N, D, 81 + D, cuda, dtype)
    g = torch.Generator().manual_seed(P + M)
    ii = torch.randint(0, 3, (P,), generator=g).to(cuda)
    jj = torch.randint(0, 4, (P,), generator=g).to(cuda)
    key = str(dtype).removeprefix("torch.")
    before = cuda_gen.INCREMENT_COUNTS[key]
    got = cuda_gen.rbf_gen_increments(X, Y, ii, jj, 0.6)
    again = cuda_gen.rbf_gen_increments(X, Y, ii, jj, 0.6)
    torch.cuda.synchronize()
    assert cuda_gen.INCREMENT_COUNTS[key] == before + 2
    want = cuda_gen.rbf_gen_increments_plain(X, Y, ii, jj, 0.6)
    assert got.shape == (P, M - 1, N - 1) and got.dtype == dtype
    assert torch.equal(got, want) and torch.equal(again, got)


def test_increments_kernel_launches_nothing_without_cells(cuda):
    X = _paths(3, 1, 2, 90, cuda, torch.float64)
    Y = _paths(3, 6, 2, 91, cuda, torch.float64)
    ii = torch.arange(3, device=cuda)
    empty = torch.zeros(0, dtype=torch.int64, device=cuda)
    before = dict(cuda_gen.INCREMENT_COUNTS)
    assert cuda_gen.rbf_gen_increments(X, Y, ii, ii, 1.0).shape == (3, 0, 5)
    assert cuda_gen.rbf_gen_increments(Y, Y, empty, empty, 1.0).shape == (
        0, 5, 5)
    assert dict(cuda_gen.INCREMENT_COUNTS) == before


class _AutogradRBF(skt.RBFKernel):
    """``RBFKernel`` by another type: ``_GridPairs`` builds its grids in
    PyTorch and differentiates them by autograd, the route K9 and K4
    replace for ``RBFKernel`` itself."""


# max |K9 + K4 route - autograd route| / max |autograd route| allowed for the
# scoring rule's value and gradients in float64: on an H100 dX read 1.9e-12
# and 2.4e-12 (value 1.5e-13, d sigma 5.0e-14), so about 4x room
_K9_ROUTE_BAR = 1e-11


def test_scoring_rule_on_k9_and_k4_matches_the_autograd_route(cuda):
    """``sig_scoring_rule`` at the ``longpath.scoring`` cell's shape (32
    paths against 1, length 1024, dim 5, dyadic 2, float64; 342 + 186 + 32
    pairs a grid chunk): value and gradients in X and sigma within
    ``_K9_ROUTE_BAR`` of the autograd route, with K9 three launches forward
    and three backward, and K4 three. The two routes round each cell's
    double difference, a cancellation of four values near 1, in other op
    orders (K9 as ``gen_increments``, the autograd route as
    ``RBFKernel.batch_kernel``'s einsum)."""
    X = _paths(32, 1024, 5, 95, cuda, torch.float64)
    y = _paths(1, 1024, 5, 96, cuda, torch.float64)
    runs = {}
    for name, kind in (("k9", skt.RBFKernel), ("autograd", _AutogradRBF)):
        x = X.clone().requires_grad_()
        sigma = torch.tensor(1.0, dtype=torch.float64, device=cuda,
                             requires_grad=True)
        k9, k4 = cuda_gen.INCREMENT_COUNTS["float64"], incvjp.COUNTS["float64"]
        v = skt.sig_scoring_rule(kind(sigma), x, y, dyadic_order=2)
        v.backward()
        torch.cuda.synchronize()
        launched = (cuda_gen.INCREMENT_COUNTS["float64"] - k9,
                    incvjp.COUNTS["float64"] - k4)
        assert launched == ((6, 3) if name == "k9" else (0, 0))
        runs[name] = (v.detach(), x.grad, sigma.grad)
    for got, want in zip(runs["k9"], runs["autograd"]):
        assert _max_rel(got, want) <= _K9_ROUTE_BAR


def test_scoring_rule_on_k9_and_k4_is_deterministic_when_asked(cuda):
    """With ``torch.use_deterministic_algorithms(True)`` K4's scatter of the
    pairs onto a repeated path index (``index_add_``) takes PyTorch's
    sorted, deterministic way, so two runs of the scoring rule on K9 and K4
    (8 paths against 1 at the cell's length: every path index repeats in
    the symmetric triangle) give the same value and gradients bit for
    bit."""
    X = _paths(8, 1024, 5, 97, cuda, torch.float64)
    y = _paths(1, 1024, 5, 98, cuda, torch.float64)
    runs = []
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for _ in range(2):
            x = X.clone().requires_grad_()
            sigma = torch.tensor(1.0, dtype=torch.float64, device=cuda,
                                 requires_grad=True)
            k4 = incvjp.COUNTS["float64"]
            v = skt.sig_scoring_rule(skt.RBFKernel(sigma), x, y,
                                     dyadic_order=2)
            v.backward()
            torch.cuda.synchronize()
            assert incvjp.COUNTS["float64"] > k4
            runs.append((v.detach(), x.grad, sigma.grad))
    finally:
        torch.use_deterministic_algorithms(was)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# ---- K10 and K11: the Linear increment grids and their VJP ----------------

# pairs, M, N, D: the Linear training cell's chunk shape (1024 x 1024, D 3);
# M < N and M > N with a short last band (64 rows) and a short last chunk
# of columns (512); D 1; D 9 and 13, past the register instances (K10: any
# D through __ldg; K11: a second pass of coordinates); M = 2 and N = 2; a
# warp's span cut mid-way (N - 1 = 1100)
_LINEAR_CASES = [(4, 1024, 1024, 3), (6, 70, 200, 3), (6, 200, 70, 3),
                 (5, 134, 600, 1), (4, 90, 40, 9), (3, 40, 130, 13),
                 (6, 2, 90, 5), (6, 90, 2, 8), (3, 66, 1101, 2)]
# K11 against its plain version (``bmm``), max |err| / max |plain|: the two
# sum each row and column in other orders
_K11_BAR = {torch.float64: 1e-13, torch.float32: 1e-5}


def _linear_inputs(P, M, N, D, cuda, dtype):
    X = _paths(3, M, D, 100 + D, cuda, dtype)
    Y = _paths(4, N, D, 101 + D, cuda, dtype)
    g = torch.Generator().manual_seed(P + M + N)
    ii = torch.randint(0, 3, (P,), generator=g).to(cuda)
    jj = torch.randint(0, 4, (P,), generator=g).to(cuda)
    return (cuda_lgen.scaled_increments(X, 0.8),
            cuda_lgen.scaled_increments(Y, 0.8), ii, jj)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("P,M,N,D", _LINEAR_CASES)
def test_linear_increments_kernel_is_its_plain_version(cuda, dtype, P, M, N,
                                                       D):
    """K10 equals its plain version (``pair_increments`` of the gathered
    scaled increments) bit for bit, with repeated pair indices, and two
    launches equal each other; one launch a call."""
    a, b, ii, jj = _linear_inputs(P, M, N, D, cuda, dtype)
    key = str(dtype).removeprefix("torch.")
    before = cuda_lgen.INCREMENT_COUNTS[key]
    got = cuda_lgen.linear_gen_increments(a, b, ii, jj)
    again = cuda_lgen.linear_gen_increments(a, b, ii, jj)
    torch.cuda.synchronize()
    assert cuda_lgen.INCREMENT_COUNTS[key] == before + 2
    want = cuda_lgen.linear_gen_increments_plain(a, b, ii, jj)
    assert got.shape == (P, M - 1, N - 1) and got.dtype == dtype
    assert torch.equal(got, want) and torch.equal(again, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("P,M,N,D", _LINEAR_CASES)
def test_linear_vjp_kernel_matches_its_plain_version(cuda, dtype, P, M, N,
                                                     D):
    """K11's cotangents of the increments within ``_K11_BAR`` of its plain
    version's, and two launches equal bit for bit (fixed-order sums, no
    atomics); one launch a call."""
    a, b, ii, jj = _linear_inputs(P, M, N, D, cuda, dtype)
    g = torch.Generator(device=cuda).manual_seed(P * N)
    ct = torch.randn(P, M - 1, N - 1, generator=g, device=cuda, dtype=dtype)
    key = str(dtype).removeprefix("torch.")
    before = cuda_lgen.VJP_COUNTS[key]
    got = cuda_lgen.linear_dd_vjp(a, b, ii, jj, ct)
    again = cuda_lgen.linear_dd_vjp(a, b, ii, jj, ct)
    torch.cuda.synchronize()
    assert cuda_lgen.VJP_COUNTS[key] == before + 2
    want = cuda_lgen.linear_dd_vjp_plain(a, b, ii, jj, ct)
    for k, k2, w in zip(got, again, want):
        assert k.shape == w.shape and k.dtype == dtype
        assert torch.equal(k, k2)
        assert _max_rel(k, w) <= _K11_BAR[dtype]


def test_linear_kernels_launch_nothing_without_cells(cuda):
    a = cuda_lgen.scaled_increments(_paths(3, 1, 2, 110, cuda,
                                           torch.float64), 1.0)
    b = cuda_lgen.scaled_increments(_paths(3, 6, 2, 111, cuda,
                                           torch.float64), 1.0)
    ii = torch.arange(3, device=cuda)
    empty = torch.zeros(0, dtype=torch.int64, device=cuda)
    before = (dict(cuda_lgen.INCREMENT_COUNTS), dict(cuda_lgen.VJP_COUNTS))
    assert cuda_lgen.linear_gen_increments(a, b, ii, ii).shape == (3, 0, 5)
    assert cuda_lgen.linear_gen_increments(b, b, empty, empty).shape == (
        0, 5, 5)
    U, V = cuda_lgen.linear_dd_vjp(a, b, ii, ii, a.new_zeros(3, 0, 5))
    assert U.shape == (3, 0, 2) and V.shape == (3, 5, 2)
    assert not V.any()
    assert (dict(cuda_lgen.INCREMENT_COUNTS),
            dict(cuda_lgen.VJP_COUNTS)) == before


class _AutogradLinear(skt.LinearKernel):
    """``LinearKernel`` by another type: ``_GridPairs`` builds its grids in
    PyTorch and differentiates them by autograd (``_torch_grid_backward``),
    the route K10 and K11 replace for ``LinearKernel`` itself."""


# max |K10 + K11 route - autograd route| / max |autograd route| allowed for
# the lincomb's gradients in float64
_K10_ROUTE_BAR = 1e-11


def _linear_lincomb(kind, X, Y, W):
    x = X.clone().requires_grad_()
    scale = torch.tensor(1.0, dtype=X.dtype, device=X.device,
                         requires_grad=True)
    S = skt.sig_gram_lincomb(kind(scale), x, Y, W, dyadic_order=1,
                             pair_chunk=128)
    S.backward()
    torch.cuda.synchronize()
    return S.detach(), x.grad, scale.grad


def test_linear_lincomb_on_k10_and_k11_matches_the_autograd_route(cuda):
    """``sig_gram_lincomb`` of ``LinearKernel`` at 128 pairs (8 paths
    against 16), length 1024, dim 3, dyadic 1, float64: its gradients in X
    and scale within ``_K10_ROUTE_BAR`` of the autograd route's, with K6,
    K10 and K11 one launch each (the ``lgen`` family: K6 forward, K10's
    grid and K11 in the backward); the autograd route launches neither."""
    X = _paths(8, 1024, 3, 112, cuda, torch.float64)
    Y = _paths(16, 1024, 3, 113, cuda, torch.float64)
    W = torch.full((8, 16), 1.0 / 128, dtype=torch.float64, device=cuda)
    runs = {}
    for name, kind in (("k10", skt.LinearKernel),
                       ("autograd", _AutogradLinear)):
        counts = (cuda_lgen.COUNTS, cuda_lgen.INCREMENT_COUNTS,
                  cuda_lgen.VJP_COUNTS)
        before = [c["float64"] for c in counts]
        runs[name] = _linear_lincomb(kind, X, Y, W)
        launched = tuple(c["float64"] - b for c, b in zip(counts, before))
        assert launched == ((1, 1, 1) if name == "k10" else (0, 0, 0))
    (v, dX, ds), (wv, wdX, wds) = runs["k10"], runs["autograd"]
    assert _max_rel(v, wv) <= _K10_ROUTE_BAR
    assert _max_rel(dX, wdX) <= _K10_ROUTE_BAR
    assert _max_rel(ds, wds) <= _K10_ROUTE_BAR


def test_linear_lincomb_on_k10_and_k11_is_deterministic_when_asked(cuda):
    """With ``torch.use_deterministic_algorithms(True)`` the scatter of
    K11's outputs onto a repeated path index takes PyTorch's deterministic
    way, so two runs of the ``sym`` lincomb (12 paths, every index
    repeating in the triangle) give the same value and gradients bit for
    bit."""
    X = _paths(12, 1024, 3, 114, cuda, torch.float64)
    W = torch.full((12, 12), 1.0 / 144, dtype=torch.float64, device=cuda)
    runs = []
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for _ in range(2):
            x = X.clone().requires_grad_()
            scale = torch.tensor(1.0, dtype=torch.float64, device=cuda,
                                 requires_grad=True)
            k11 = cuda_lgen.VJP_COUNTS["float64"]
            S = skt.sig_gram_lincomb(skt.LinearKernel(scale), x, x, W,
                                     sym=True, dyadic_order=1)
            S.backward()
            torch.cuda.synchronize()
            assert cuda_lgen.VJP_COUNTS["float64"] > k11
            runs.append((S.detach(), x.grad, scale.grad))
    finally:
        torch.use_deterministic_algorithms(was)
    assert all(torch.equal(a, b) for a, b in zip(*runs))
