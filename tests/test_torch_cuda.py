"""The port's CUDA kernels against their plain versions, on the card.

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
from sigkernel_tpu_torch.ops import _build, cuda_gen, cuda_solver
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
    rows = _build.SMEM_BYTES // (3 * 8)        # one row past the f64 bound
    inc = torch.zeros(1, rows // 4 + 1, rows // 4 + 1, dtype=torch.float64,
                      device=cuda)
    with pytest.raises(ValueError, match="shared"):
        cuda_solver.inc_solve_final(inc, dyadic_order=2)


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
