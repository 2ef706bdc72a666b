"""K7's band-pipelined decomposition (``csrc/band_sweep.cuh``), emulated in
plain PyTorch by ``cuda_blocked.stripe_solve_banded_plain``: bands of ``H``
rows swept one after another, each in chunks of ``Wc`` columns handed on
from the band above, with the kernel's own index arithmetic for the
increments. It must equal the plain stripe (``stripe_solve_plain``, and
``stripe_solve_stack_plain`` for K7-stack) bit for bit, over both dtypes,
both schemes, dyadic orders 0-2, ``flip``, a short last band and a short
last chunk, and a band wholly past the frame (the striped adjoint's zero
padding); and, through the same inputs, JAX's ``solve_stripe``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigkernel_tpu.ops import scan_solver as jscan
from sigkernel_tpu.utils import dyadic_refine as jrefine

from sigkernel_tpu_torch.ops import cuda_blocked

# base grids (P, Mb, Nb) per dyadic order, transposed in the solve's frame
# (Mb > Nb): refined R = 41, 42, 44 rows and C = 50, 52, 52 columns
_BASE = {0: (2, 50, 41), 1: (2, 26, 21), 2: (2, 13, 11)}
# "inside": frame rows f .. R - 1; "pad": 48 rows from R - 2 f, whose rows
# past the frame's R fill a whole band at H = 32
_CASES = ["inside", "pad"]
# (H, Wc): bands of 32 rows (two bands, the last short) or 64 (one short
# band); chunks of 8 (a short last chunk at every C here) or 13
_TILES = [(32, 8), (32, 13), (64, 8), (64, 13)]


def _stripe(dyadic, case, dtype, seed):
    rng = np.random.default_rng(seed)
    f = 2 ** dyadic
    P, Mb, Nb = _BASE[dyadic]
    inc = rng.normal(size=(P, Mb, Nb)) * 0.3
    R, C = cuda_blocked.frame(Mb, Nb, dyadic)
    row0, rows = (f, R - f) if case == "inside" else (R - 2 * f, 48)
    bd = 1.0 + 0.1 * rng.random(size=(P, C + 1))
    bd[:, 0] = 1.0
    return inc, bd, row0, rows, torch.tensor(inc, dtype=dtype), torch.tensor(
        bd, dtype=dtype)


@pytest.mark.parametrize("H,Wc", _TILES)
@pytest.mark.parametrize("case", _CASES)
@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("dyadic", [0, 1, 2])
@pytest.mark.parametrize("naive", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_banded_bottom_row_is_the_plain_stripe(dtype, naive, dyadic, flip,
                                               case, H, Wc):
    _, _, row0, rows, inc, bd = _stripe(dyadic, case, dtype, 0)
    got = cuda_blocked.stripe_solve_banded_plain(inc, bd, row0, rows, dyadic,
                                                 naive, flip, H, Wc)
    want = cuda_blocked.stripe_solve_plain(inc, bd, row0, rows, dyadic,
                                           naive, flip)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", _CASES)
@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("dyadic", [0, 1, 2])
@pytest.mark.parametrize("naive", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_banded_stack_is_the_plain_stack(dtype, naive, dyadic, flip, case):
    """Every entry of K7-stack's stack as the kernel writes it: the swept
    cells on their diagonals, row 0 = bd, 1 at column 0, 0 outside."""
    _, _, row0, rows, inc, bd = _stripe(dyadic, case, dtype, 1)
    got = cuda_blocked.stripe_solve_banded_plain(inc, bd, row0, rows, dyadic,
                                                 naive, flip, 32, 13,
                                                 stack=True)
    want = cuda_blocked.stripe_solve_stack_plain(inc, bd, row0, rows, dyadic,
                                                 naive, flip)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("rows,H,Wc", [(8, 32, 32), (40, 32, 32),
                                       (20, 128, 32)])
def test_one_pair_and_a_band_taller_than_the_stripe(rows, H, Wc):
    """P = 1 and ``rows < H`` (one short band), at the kernel's sizes."""
    rng = np.random.default_rng(2)
    inc = torch.tensor(rng.normal(size=(1, 45, 41)) * 0.3)
    bd = torch.ones(1, 46, dtype=torch.float64)
    got = cuda_blocked.stripe_solve_banded_plain(inc, bd, 0, rows, 0, False,
                                                 False, H, Wc)
    assert torch.equal(got, cuda_blocked.stripe_solve_plain(inc, bd, 0, rows))


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("dyadic", [0, 2])
def test_banded_stripe_matches_jax_solve_stripe(dyadic, flip):
    """JAX's ``solve_stripe`` on the same stripe (refined, zero-padded and
    flipped in numpy), float64 within 1e-12 relative."""
    inc_np, bd_np, row0, rows, inc, bd = _stripe(dyadic, "pad", torch.float64,
                                                 3)
    base = np.swapaxes(inc_np, -1, -2)  # the solve's frame
    full = np.asarray(jrefine(jnp.asarray(base), dyadic))
    stripe = np.zeros((full.shape[0], rows, full.shape[2]))
    n = min(rows, full.shape[1] - row0)
    stripe[:, :n] = full[:, row0:row0 + n]
    if flip:
        stripe = stripe[:, ::-1, ::-1]
    want = np.asarray(jscan.solve_stripe(jnp.asarray(stripe.copy()),
                                         jnp.asarray(bd_np)))
    got = cuda_blocked.stripe_solve_banded_plain(inc, bd, row0, rows, dyadic,
                                                 False, flip).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_band_constants_match_the_kernel_source():
    """The wrapper sizes K7's scratch from BAND_ROWS; the kernel checks the
    band count it is given against its own kBandRows."""
    from pathlib import Path

    src = (Path(cuda_blocked.__file__).parent.parent / "csrc"
           / "band_sweep.cuh").read_text()
    assert "kBandRows = 32 * kBandWarps" in src
    assert "constexpr int kBandWarps = 4;" in src
    assert "constexpr int kChunk = 32;" in src
    assert (cuda_blocked.BAND_ROWS, cuda_blocked.CHUNK) == (128, 32)
