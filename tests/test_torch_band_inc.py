"""K2, K2-stack and K2-sparse on the band-pipelined wavefront
(``csrc/band_sweep.cuh`` with ``IncSource``; K2-sparse in its sparse-stack
mode, kBandSparse), emulated in plain PyTorch by ``cuda_solver``'s
``inc_solve_final_banded_plain``, ``inc_solve_stack_banded_plain`` and
``inc_solve_sparse_banded_plain``: each pair's whole frame (transposed when
``Mb > Nb``) from a row 0 of 1s, its refined increments by the kernel's
index arithmetic, swept in bands of ``H`` rows and chunks of ``Wc``
columns; the sparse stack written entry by entry as the kernel's mode
writes it, into a stack of NaN. They must equal the plain versions
(``inc_solve_final_plain``, ``inc_solve_stack_plain``,
``inc_solve_sparse_plain``) bit for bit over both dtypes, both schemes,
dyadic orders 0-3, ``Mb < Nb``, ``Mb == Nb`` and ``Mb > Nb``, frames of
fewer than 32 rows and of a row count that is no multiple of the band,
and windows W = 2, 3 and 8; and, on the same numpy inputs, the JAX
package's scan tier within 1e-12 relative. K8's plain version on the
emulated sparse stack must give K3<inc>'s plain cotangent on the full
stack, bit for bit.

The negative control: the hand-off row between two bands read as 1s
breaks the bit-equality on every case of more than one band. The wrappers
(on meta tensors posing as CUDA ones) take a shorter side past
``_build.max_rows`` (their split: ``tests/test_torch_band.py``);
``routes.resolve_inc_tier`` still sends such grids to the stripes, for
K3<inc>, which keeps its row bound.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigkernel_tpu.ops import scan_solver as jscan
from sigkernel_tpu.utils import dyadic_refine as jrefine

from sigkernel_tpu_torch.ops import _build, cuda_solver, routes, scan_solver

# (Mb, Nb, dyadic, H, Wc): R = min(Mb, Nb) 2^dyadic rows, the frame
# transposed when Mb > Nb; bands of H rows and chunks of Wc columns, the
# last ones short on most frames ((128, 32) are the kernel's own)
_CASES = [
    (3, 4, 0, 2, 3),       # R 3, C 4: bands of 2 rows, a short last one
    (4, 3, 0, 2, 3),       # the same, transposed
    (5, 5, 1, 4, 3),       # Mb == Nb, R 10: bands 4, 4, 2
    (5, 7, 2, 8, 6),       # R 20, C 28: short last band and chunk
    (7, 5, 1, 8, 6),       # transposed, dyadic 1
    (3, 4, 3, 16, 13),     # dyadic 3: R 24, C 32
    (9, 14, 1, 16, 13),    # R 18: no multiple of 32 or of H
    (2, 3, 2, 128, 32),    # the kernel's band and chunk: R 8
    (35, 40, 0, 32, 32),   # R 35: a second band of 3 rows
    (1, 1, 0, 128, 32),    # R 1, C 1: one cell
]
_DTYPES = {"f64": torch.float64, "f32": torch.float32}
_WINDOWS = [2, 3, 8]


def _case_id(case):
    return "Mb{}-Nb{}-d{}-H{}-W{}".format(*case)


def _grid(Mb, Nb, seed=0, P=2):
    """A numpy-seeded base increment grid (P, Mb, Nb)."""
    return np.random.default_rng(seed).normal(size=(P, Mb, Nb)) * 0.3


def _multi_band(case):
    Mb, Nb, dyadic, H, _ = case
    return min(Mb, Nb) * 2 ** dyadic > H


@pytest.mark.parametrize("naive", [False, True])
@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("case", _CASES, ids=_case_id)
def test_banded_k2_is_the_plain_k2(case, dtype, naive):
    Mb, Nb, dyadic, H, Wc = case
    inc = torch.tensor(_grid(Mb, Nb), dtype=_DTYPES[dtype])
    got = cuda_solver.inc_solve_final_banded_plain(inc, dyadic, naive, H, Wc)
    want = cuda_solver.inc_solve_final_plain(inc, dyadic, naive)
    assert got.dtype == _DTYPES[dtype] and got.shape == want.shape == (2,)
    assert torch.equal(got, want)


@pytest.mark.parametrize("naive", [False, True])
@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("case", _CASES, ids=_case_id)
def test_banded_k2_stack_is_the_plain_stack(case, dtype, naive):
    """Every entry of K2-stack's stack as the band kernel writes it: row 0
    the constant 1 to column C, the swept cells on their diagonals, 1 at
    column 0, 0 outside; and the values."""
    Mb, Nb, dyadic, H, Wc = case
    inc = torch.tensor(_grid(Mb, Nb, 1), dtype=_DTYPES[dtype])
    got = cuda_solver.inc_solve_stack_banded_plain(inc, dyadic, naive, H, Wc)
    want = cuda_solver.inc_solve_stack_plain(inc, dyadic, naive)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("W", _WINDOWS)
@pytest.mark.parametrize("naive", [False, True])
@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("case", _CASES, ids=_case_id)
def test_banded_k2_sparse_is_the_plain_sparse(case, dtype, naive, W,
                                              monkeypatch):
    """Every entry of the sparse stack as the sparse-stack mode writes it
    (a NaN left anywhere fails), and the values."""
    Mb, Nb, dyadic, H, Wc = case
    monkeypatch.setattr(cuda_solver, "CKPT_WINDOW", W)
    inc = torch.tensor(_grid(Mb, Nb, 2), dtype=_DTYPES[dtype])
    got = cuda_solver.inc_solve_sparse_banded_plain(inc, dyadic, naive, H, Wc)
    want = cuda_solver.inc_solve_sparse_plain(inc, dyadic, naive)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("W", _WINDOWS)
@pytest.mark.parametrize("case", _CASES[2:6], ids=_case_id)
def test_sparse_emulation_feeds_k8_as_the_full_stack(case, W, monkeypatch):
    """K8's plain version on the emulated sparse stack equals K3<inc>'s
    plain version on the full stack, bit for bit."""
    Mb, Nb, dyadic, H, Wc = case
    monkeypatch.setattr(cuda_solver, "CKPT_WINDOW", W)
    inc = torch.tensor(_grid(Mb, Nb, 3))
    _, sparse = cuda_solver.inc_solve_sparse_banded_plain(inc, dyadic, False,
                                                          H, Wc)
    _, stack = cuda_solver.inc_solve_stack_plain(inc, dyadic)
    got = cuda_solver.inc_adjoint_ckpt_plain(inc, sparse, dyadic)
    want = cuda_solver.inc_adjoint_plain(inc, stack, dyadic)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", [_CASES[i] for i in (1, 3, 5, 8)],
                         ids=_case_id)
def test_banded_k2_matches_jax_scan_tier(case):
    """JAX's scan tier on the same numpy grid, refined by the JAX package,
    float64: the corner within 1e-12 relative, and each stored diagonal of
    the sparse stack against JAX's solution grid within 1e-12 of its max
    |K| (entries near 0 make an entry-wise bar meaningless)."""
    Mb, Nb, dyadic, H, Wc = case
    g = _grid(Mb, Nb, 4)
    ref = jrefine(jnp.asarray(g), dyadic)
    want = np.asarray(jscan.solve_final(ref))
    inc = torch.tensor(g)
    got = cuda_solver.inc_solve_final_banded_plain(inc, dyadic, False, H, Wc)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)
    full = np.asarray(jscan.solve_grid(ref))
    frame = np.swapaxes(full, -1, -2) if Mb > Nb else full
    _, sparse = cuda_solver.inc_solve_sparse_banded_plain(inc, dyadic, False,
                                                          H, Wc, W=3)
    R, C = frame.shape[-2] - 1, frame.shape[-1] - 1
    bar = 1e-12 * np.abs(frame).max()
    for r in range(sparse.shape[1]):
        p = (r // 2) * 3 + r % 2
        i = np.arange(max(0, p - C), min(R, p) + 1)
        assert np.abs(sparse[:, r, i].numpy() - frame[:, i, p - i]).max() \
            <= bar


def _ones(row):
    return torch.ones_like(row)


@pytest.mark.parametrize("case", [c for c in _CASES if _multi_band(c)],
                         ids=_case_id)
def test_negative_control_breaks_the_bit_equality(case):
    """The hand-off row between bands read as 1s: the corner, the stack and
    the sparse stack all differ from the plain versions."""
    Mb, Nb, dyadic, H, Wc = case
    inc = torch.tensor(_grid(Mb, Nb, 5))
    got = cuda_solver.inc_solve_final_banded_plain(inc, dyadic, False, H, Wc,
                                                   handoff=_ones)
    assert not torch.equal(got, cuda_solver.inc_solve_final_plain(inc,
                                                                  dyadic))
    _, stack = cuda_solver.inc_solve_stack_banded_plain(inc, dyadic, False, H,
                                                        Wc, handoff=_ones)
    _, want = cuda_solver.inc_solve_stack_plain(inc, dyadic)
    assert not torch.equal(stack, want)
    _, sparse = cuda_solver.inc_solve_sparse_banded_plain(
        inc, dyadic, False, H, Wc, W=2, handoff=_ones)
    assert not torch.equal(sparse, scan_solver.stack_to_sparse(want, 2))


def test_length_one_path_and_no_pairs():
    """A length-1 path: K is its boundary, 1; no pairs: no values."""
    for shape in ((3, 0, 5), (3, 4, 0), (0, 4, 5)):
        inc = torch.zeros(shape, dtype=torch.float64)
        got = cuda_solver.inc_solve_final_banded_plain(inc, 2, H=2, Wc=3)
        assert torch.equal(got, cuda_solver.inc_solve_final_plain(inc, 2))
        assert got.shape == (shape[0],) and bool((got == 1).all())


@pytest.fixture
def posing_as_cuda(monkeypatch):
    """Meta tensors pass the K2 wrappers' checks, and each launch is
    recorded (not run)."""
    launches = []
    monkeypatch.setattr(cuda_solver, "_check", lambda inc, what: None)
    monkeypatch.setattr(_build, "launch", lambda what, fns, counts, t, *args,
                        key=None: launches.append((what, fns, key, args)))
    return launches


def _meta(P, Mb, Nb, dtype=torch.float64):
    return torch.empty(P, Mb, Nb, device="meta", dtype=dtype)


def _wrappers():
    return {"inc_wavefront": (cuda_solver.inc_solve_final, cuda_solver._FNS),
            "inc_wavefront[stack]": (cuda_solver.inc_solve_stack,
                                     cuda_solver._STACK_FNS),
            "inc_wavefront[sparse]": (cuda_solver.inc_solve_sparse,
                                      cuda_solver._SPARSE_FNS)}


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_no_row_bound_on_the_card(posing_as_cuda, dtype):
    """Past the one-block kernel's bound (9,684 rows in double, 19,369 in
    float) each wrapper launches its band kernel: one launch of one pair,
    157 bands of 128 rows at 20,000 rows (length 5,001, dyadic 2)."""
    t = _DTYPES[dtype]
    assert 5000 * 4 > _build.max_rows(torch.empty((), dtype=t).element_size())
    for what, (wrapper, fns) in _wrappers().items():
        out = wrapper(_meta(1, 5000, 5000, t), 2)
        value = out if what == "inc_wavefront" else out[0]
        assert value.shape == (1,)
        got, fns_got, key, args = posing_as_cuda.pop()
        assert (got, fns_got, key) == (what, fns, None)
        tail = (5000, 5000, 4) + ((8,) if "sparse" in what else ()) + (157, 0)
        assert args[-len(tail) - 1:] == (1,) + tail
    assert not posing_as_cuda


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_routes_keep_the_stripes_past_the_row_bound(dtype):
    """K3<inc> is still one block a pair within the row bound, so the
    routes send a grid past it to the stripes, forward and backward."""
    size = torch.empty((), dtype=_DTYPES[dtype]).element_size()
    rows = _build.max_rows(size) + 1
    assert routes.resolve_inc_tier((rows, rows + 5), size) == "stripes"
    assert routes.resolve_inc_tier((rows, rows + 5), size, True) == "striped"
    assert routes.resolve_inc_tier((rows - 1, rows), size) == "single"
