"""K3<inc, boundary>'s band kernel (``csrc/band_sweep.cuh``, kBandAdjoint),
emulated in plain PyTorch by ``cuda_blocked.stripe_adjoint_banded_plain``:
the reverse stripe swept in bands of ``H`` rows and chunks of ``Wc``
columns with the kernel's index arithmetic, each cell's product with the
forward stack entry the kernel reads, and the collapse run lane by lane in
the kernel's order (two open base cells a group of ``f`` lanes). It must
equal the plain version (``stripe_adjoint_plain``) bit for bit over both
dtypes, both schemes, dyadic orders 0-2 and 5 (a group of 32 lanes, a whole
warp), a stripe inside the frame and a zero-padded last stripe with a band
wholly past the frame, both frames (transposed when ``Mb > Nb``), a short
last band and chunk and ``rows < H``; and, through the striped adjoint,
JAX's grid route. Past ``f = 32`` the wrapper takes the one-block kernel."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigkernel_tpu.ops import solve as jsolve

from sigkernel_tpu_torch.ops import _build, cuda_blocked

# base grids (P, Mb, Nb) per dyadic order, in the solve's frame (Nb >= Mb):
# refined R = 41, 42, 44 rows and C = 50, 52, 52 columns; `transpose` swaps
# Mb and Nb (the solve then runs transposed and ct is written so)
_BASE = {0: (2, 41, 50), 1: (2, 21, 26), 2: (2, 11, 13)}
# "inside": frame rows f .. R - 1; "pad": 48 rows from R - 2 f, whose first
# 32 reverse rows (forward rows past the frame's R) fill a band at H = 32
_CASES = ["inside", "pad"]
# (H, Wc): two bands of 32 rows, the last short, in chunks of 13 (a short
# last chunk); one band of 64, taller than the stripe, in chunks of 8
_TILES = [(32, 13), (64, 8)]


def _stripe(P, Mb, Nb, dyadic, case, dtype, seed):
    """``(inc, stack, bd, ct, row0, rows)``: forward stripe ``case``'s
    stack from a boundary, the reverse stripe's boundary, and a cotangent
    that already holds values (the kernel adds into it)."""
    rng = np.random.default_rng(seed)
    f = 2 ** dyadic
    R, C = cuda_blocked.frame(Mb, Nb, dyadic)
    row0, rows = (f, R - f) if case == "inside" else (R - 2 * f, 48)
    inc = torch.tensor(rng.normal(size=(P, Mb, Nb)) * 0.3, dtype=dtype)
    bd_f, bd_r = (torch.tensor(1.0 + 0.1 * rng.random(size=(P, C + 1)),
                               dtype=dtype) for _ in range(2))
    bd_f[:, 0] = bd_r[:, 0] = 1.0
    _, stack = cuda_blocked.stripe_solve_stack_plain(inc, bd_f, row0, rows,
                                                     dyadic)
    ct = torch.tensor(rng.normal(size=(P, Mb, Nb)), dtype=dtype)
    return inc, stack, bd_r, ct, row0, rows


def _both(inc, stack, bd, ct, row0, rows, dyadic, naive, H, Wc):
    got = cuda_blocked.stripe_adjoint_banded_plain(
        inc, stack, bd, ct.clone(), row0, rows, dyadic, naive, H, Wc)
    want = cuda_blocked.stripe_adjoint_plain(inc, stack, bd, ct.clone(), row0,
                                             rows, dyadic, naive)
    return got, want


@pytest.mark.parametrize("H,Wc", _TILES)
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("case", _CASES)
@pytest.mark.parametrize("dyadic", [0, 1, 2])
@pytest.mark.parametrize("naive", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_banded_adjoint_is_the_plain_adjoint(dtype, naive, dyadic, case,
                                             transpose, H, Wc):
    P, Mb, Nb = _BASE[dyadic]
    if transpose:
        Mb, Nb = Nb, Mb
    args = _stripe(P, Mb, Nb, dyadic, case, dtype, dyadic)
    got, want = _both(*args, dyadic, naive, H, Wc)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("row0", [0, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_a_base_row_of_a_whole_warp(dtype, row0):
    """Dyadic 5: f = 32, one group a warp (R 64, C 96, transposed): the
    whole frame, and a stripe of two base rows whose second lies past it."""
    inc, _, bd, ct, _, _ = _stripe(2, 3, 2, 5, "inside", dtype, 5)
    stack = cuda_blocked.stripe_solve_stack_plain(inc, torch.ones_like(bd),
                                                  row0, 64, 5)[1]
    got, want = _both(inc, stack, bd, ct, row0, 64, 5, False, 32, 13)
    assert torch.equal(got, want)


@pytest.mark.parametrize("rows,H,Wc", [(8, 32, 32), (20, 128, 32)])
def test_one_pair_and_a_stripe_shorter_than_a_warp(rows, H, Wc):
    """P = 1 and ``rows`` < 32 (one warp, partly past the stripe), at
    dyadic 2 and at the kernel's sizes."""
    inc, stack, bd, ct, _, _ = _stripe(1, 12, 11, 2, "inside", torch.float64,
                                       7)
    stack = cuda_blocked.stripe_solve_stack_plain(inc, torch.ones_like(bd), 8,
                                                  rows, 2)[1]
    got, want = _both(inc, stack, bd, ct, 8, rows, 2, False, H, Wc)
    assert torch.equal(got, want)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("dyadic", [0, 2])
def test_striped_adjoint_on_the_band_kernel_matches_jax(monkeypatch, dyadic,
                                                        transpose):
    """The striped adjoint with each stripe's K3<inc, boundary> emulated
    band by band (stripes of 3 base rows, the last zero-padded) against JAX
    ``_grid_route_bwd`` on the scan tier: float64 within 1e-12 of max |ref|."""
    rng = np.random.default_rng(11 + dyadic)
    shape = (2, 13, 8) if transpose else (2, 8, 13)
    inc = rng.normal(size=shape) * 0.3
    g = rng.normal(size=2)
    (want,) = jsolve._grid_route_bwd(jnp.asarray(inc), jnp.asarray(g), False,
                                     "scan", dyadic)
    monkeypatch.setattr(cuda_blocked, "stripe_adjoint", functools.partial(
        cuda_blocked.stripe_adjoint_banded_plain, H=4, Wc=5))
    ct = cuda_blocked.adjoint(torch.tensor(inc), dyadic, rows=3 * 2 ** dyadic)
    got = (ct * torch.tensor(g)[:, None, None]).numpy()
    want = np.asarray(want)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_f_past_a_warp_takes_the_one_block_kernel():
    """The route rule: the band kernel while a base row's f rows fit one
    warp, the one-block kernel (and its row bound) past it; the emulation
    refuses what the band kernel cannot run."""
    assert [cuda_blocked.stripe_adjoint_kernel(d) for d in range(8)] == (
        ["band"] * 6 + ["one_block"] * 2)
    assert cuda_blocked.WARP == 32 and "one_block" in (
        cuda_blocked.ADJOINT_COUNTS)
    inc, stack, bd, ct, _, _ = _stripe(1, 2, 3, 6, "inside", torch.float64, 0)
    with pytest.raises(ValueError, match="one warp"):
        cuda_blocked.stripe_adjoint_banded_plain(inc, stack, bd, ct, 0, 128,
                                                 6)


def test_the_row_bound_holds_for_the_one_block_route_only(monkeypatch):
    """``_check`` past the row bound: refused on the one-block route,
    accepted on the band route (which holds no stripe in shared memory).
    Run on a tensor posing as a CUDA one."""
    from sigkernel_tpu_torch.ops import cuda_solver

    monkeypatch.setattr(cuda_solver, "_check", lambda inc, what: None)
    monkeypatch.setattr(_build, "max_rows", lambda itemsize: 16)
    inc = torch.zeros(1, 10, 12, dtype=torch.float64)
    bd = torch.ones(1, 12 * 2 + 1, dtype=torch.float64)
    assert cuda_blocked._check(inc, bd, 0, 20, 1, "x")[4] == 24
    with pytest.raises(ValueError, match="one block a pair"):
        cuda_blocked._check(inc, bd, 0, 20, 1, "x", one_block=True)
    assert cuda_blocked._check(inc, bd, 0, 16, 1, "x", one_block=True)[3] == 2
