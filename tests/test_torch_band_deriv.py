"""K5 on the band-pipelined wavefront (``csrc/band_sweep.cuh`` with
``DerivSource``), emulated in plain PyTorch by
``cuda_deriv.deriv_solve_banded_plain``: the three grids' refined
increments by the kernel's index arithmetic, the whole frame (transposed
when ``Mb > Nb``) swept in bands of ``H`` rows and chunks of ``Wc``
columns, every hand-off carrying the three states (K, K_diff, K_diffdiff)
of its row or column. It must equal K5's plain version
(``deriv_solve_final_plain``) bit for bit over both dtypes, dyadic orders 0,
1, 2 and 5, transposed grids, frames whose rows are no multiple of 32 or of
``H``, a short last band and a short last chunk, and a length-1 path; and
JAX's scan tier (``sigkernel_tpu.ops.scan_solver.solve_derivatives_final``)
on the same numpy-seeded grids within 1e-12 (float64: K entry-wise
relative) and 1e-5 (float32), of max |ref| otherwise, as
``test_torch_derivatives.py`` measures. At dyadic 5 (10^4 cells and more)
the float32 bar is the repo's 1e-4: there JAX's own float32 sweep sits
1.5e-4 of max |K| from its float64 one, and the two float32 loops 3.6e-5
apart (they round the same recurrences, but XLA may contract).

The negative controls: a hand-off between bands that carries K alone (K_diff
and K_diffdiff zeroed), and one with K_diff and K_diffdiff swapped, each
make the derivatives differ on every case with more than one band. The
wrapper's launches (on meta tensors posing as CUDA ones) take no row bound
(their split: ``tests/test_torch_band.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigkernel_tpu.ops import scan_solver as jscan
from sigkernel_tpu.utils import dyadic_refine as jrefine

from sigkernel_tpu_torch.ops import _build, cuda_deriv

# (Mb, Nb, dyadic, H, Wc): R = min(Mb, Nb) 2^dyadic rows, the grids
# transposed in the kernel's frame when Mb > Nb; bands of H rows and chunks
# of Wc columns, the last ones short on most frames ((128, 32) are the
# kernel's own)
_CASES = [
    (3, 4, 0, 2, 3),       # R 3, C 4: a band of one row, a chunk of one
    (4, 3, 0, 2, 3),       # the same, transposed
    (1, 4, 2, 2, 3),       # a base row of one, R 4, C 16
    (5, 7, 2, 8, 6),       # R 20, C 28: short last band and chunk
    (7, 5, 1, 8, 6),       # transposed, dyadic 1
    (9, 14, 1, 16, 13),    # R 18: no multiple of 32 or of H
    (2, 3, 5, 32, 32),     # dyadic 5: R 64, C 96
    (3, 2, 5, 48, 40),     # dyadic 5, transposed, short band and chunk
    (5, 6, 5, 128, 32),    # R 160: a second band of 32 rows
    (1, 1, 0, 128, 32),    # R 1, C 1: one cell
]
_DTYPES = {"f64": torch.float64, "f32": torch.float32}
# against JAX: float64 K entry-wise relative, the rest of max |ref|;
# float32 at dyadic 5 (see above)
_JAX_BARS = {"f64": 1e-12, "f32": 1e-5}
F32_LONG_BAR = 1e-4


def _case_id(case):
    return "Mb{}-Nb{}-d{}-H{}-W{}".format(*case)


def _grids(Mb, Nb, dtype, P=2, seed=0):
    """Three numpy-seeded base grids (P, Mb, Nb), the derivative Gram's
    increments at a plausible scale."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(P, Mb, Nb)) * s for s in (0.3, 0.5, 0.8)]


def _torch(grids, dtype):
    return [torch.tensor(g, dtype=dtype) for g in grids]


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("case", _CASES, ids=_case_id)
def test_banded_k5_is_the_plain_k5(dtype, case):
    Mb, Nb, dyadic, H, Wc = case
    grids = _torch(_grids(Mb, Nb, dtype), _DTYPES[dtype])
    got = cuda_deriv.deriv_solve_banded_plain(*grids, dyadic, H=H, Wc=Wc)
    want = cuda_deriv.deriv_solve_final_plain(*grids, dyadic)
    for g, w in zip(got, want):
        assert g.shape == (2,) and g.dtype == _DTYPES[dtype]
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("case", _CASES, ids=_case_id)
def test_banded_k5_matches_jax_scan_tier(dtype, case):
    Mb, Nb, dyadic, H, Wc = case
    np_dtype = np.float64 if dtype == "f64" else np.float32
    grids = [g.astype(np_dtype) for g in _grids(Mb, Nb, dtype)]
    want = [np.asarray(w, dtype=np.float64) for w in
            jscan.solve_derivatives_final(
                *(jrefine(jnp.asarray(g), dyadic) for g in grids))]
    got = [np.asarray(t, dtype=np.float64) for t in
           cuda_deriv.deriv_solve_banded_plain(
               *_torch(grids, _DTYPES[dtype]), dyadic, H=H, Wc=Wc)]
    bar = F32_LONG_BAR if dtype == "f32" and dyadic == 5 else _JAX_BARS[dtype]
    if dtype == "f64":
        assert np.max(np.abs(got[0] - want[0]) / np.abs(want[0])) <= bar
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= bar * np.abs(w).max()


def _zero_derivatives(row):
    return row * row.new_tensor([1.0, 0.0, 0.0])[:, None, None]


def _swap_derivatives(row):
    return row[[0, 2, 1]]


@pytest.mark.parametrize("control", [_zero_derivatives, _swap_derivatives],
                         ids=["K alone", "K_diff and K_diffdiff swapped"])
@pytest.mark.parametrize("case", [c for c in _CASES
                                  if min(c[:2]) * 2 ** c[2] > c[3]],
                         ids=_case_id)
def test_negative_controls_break_the_bit_equality(case, control):
    Mb, Nb, dyadic, H, Wc = case
    grids = _torch(_grids(Mb, Nb, "f64"), torch.float64)
    got = cuda_deriv.deriv_solve_banded_plain(*grids, dyadic, H=H, Wc=Wc,
                                              handoff=control)
    want = cuda_deriv.deriv_solve_final_plain(*grids, dyadic)
    assert torch.equal(got[0], want[0])  # K reads no derivative
    assert not (torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]))


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_length_one_path_and_no_pairs(dtype):
    """A length-1 path (no base rows) gives (1, 0, 0) with no sweep, as no
    pairs give empty corners."""
    for shape in ((3, 0, 5), (3, 4, 0), (0, 4, 5)):
        grids = [torch.zeros(shape, dtype=_DTYPES[dtype]) for _ in range(3)]
        got = cuda_deriv.deriv_solve_banded_plain(*grids, 2, H=2, Wc=3)
        want = cuda_deriv.deriv_solve_final_plain(*grids, 2)
        for g, w, v in zip(got, want, (1.0, 0.0, 0.0)):
            assert g.shape == (shape[0],) and torch.equal(g, w)
            assert bool((g == v).all())


@pytest.fixture
def posing_as_cuda(monkeypatch):
    """Meta tensors pass K5's checks, and each launch is recorded (not
    run)."""
    launches = []
    monkeypatch.setattr(cuda_deriv, "_check", lambda *grids: None)
    monkeypatch.setattr(_build, "launch", lambda what, fns, counts, t, *args,
                        key=None: launches.append((fns, key, args)))
    return launches


def _meta(P, Mb, Nb, dtype=torch.float64):
    return [torch.empty(P, Mb, Nb, device="meta", dtype=dtype)
            for _ in range(3)]


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_no_row_bound_on_the_card(posing_as_cuda, dtype):
    """Past the earlier one-block kernel's bound (4,840 rows in double,
    9,683 in float) K5 launches its band kernel, one launch, 64 bands a pair
    at 8,184 rows (length 1024, dyadic 3) and 157 at 20,000."""
    for L, dyadic, nbands in ((1024, 3, 64), (5001, 2, 157)):
        out = cuda_deriv.deriv_solve_final(
            *_meta(1, L - 1, L - 1, _DTYPES[dtype]), dyadic)
        assert [t.shape for t in out] == [(1,)] * 3
        fns, key, args = posing_as_cuda.pop()
        assert fns is cuda_deriv._FNS and key is None
        assert args[6:] == (1, L - 1, L - 1, 2 ** dyadic, nbands)
    assert not posing_as_cuda
