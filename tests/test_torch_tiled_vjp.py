"""K4's tiled design (``csrc/rbf_dd_vjp.cu``) emulated in plain PyTorch by
``incvjp.rbf_dd_vjp_pairs_tiled_plain``: the cells in bands of rows and
chunks of 32-column warps, each W computed once, the sums in the kernel's
fixed order (a band's column sums serial in its rows, then the bands in
order; a row's sums over a lane's columns, the halving tree over the warp's
lanes, then the warps and the chunks in order; E * D the same way, then the
pairs in order). On numpy-seeded inputs with repeated pair indices it must
match K4's plain version (``rbf_dd_vjp_plain``) and JAX
(``sigkernel_tpu.ops.df_prep.rbf_dd_vjp(..., gram=False)``, scattered with
``np.add.at``, as ``tests/test_torch_incvjp.py`` does): float64 within 1e-12
of max |ref|; float32 within 1e-5 of max |ref| for dX and dY, and for
d sigma within 1e-5 of the sum of its terms' magnitudes, sum |E D| /
sigma^2 (a sum of ~10^4 terms of both signs: float32 rounding of d sigma
relative to |d sigma| reaches ~7e-5 in the plain version too, at 600 x 130).

Negative controls: the west halo (a warp's first column reading its west
and north-west ct) read as 0 must change the result on every case with
more than one warp of columns, the north halo (a band's first row reading
the row above) on every case with more than one band, and neither may
change it elsewhere. The wrapper, on meta tensors posing as CUDA ones,
refuses no path dimension and allocates the partials in the kernel's
layout.
"""
import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigkernel_tpu.ops import df_prep

from sigkernel_tpu_torch.ops import _build, cuda_gen, incvjp

from conftest import make_paths

# name, pairs, M, N, D, band rows (None: the kernel's); pair indices drawn
# with repeats from 3 X paths and 4 Y paths
_CASES = [
    ("7x11, one warp of columns, one band", 6, 7, 11, 2, None),
    ("M 70 > N 40: a short last band of 6 rows", 6, 70, 40, 3, None),
    ("M 40 < N 150: three warps, the last short", 6, 40, 150, 1, None),
    ("N 1100: a second chunk of columns", 4, 12, 1100, 5, None),
    ("M 130: a third band of 2 rows, N 70", 4, 130, 70, 3, None),
    ("M 2: one row of increments", 6, 2, 90, 5, None),
    ("N 2: one column of increments", 6, 90, 2, 3, None),
    ("M = N = 2", 6, 2, 2, 8, None),
    ("D 8: the widest in registers", 4, 66, 80, 8, None),
    ("D 40: the wide kernel, two chunks", 4, 70, 300, 40, None),
    ("bands of 8 rows, M 33", 6, 33, 100, 5, 8),
]
_BARS = {torch.float64: 1e-12, torch.float32: 1e-5}
_SIGMA = 0.7


def _case_id(case):
    return case[0].split(":")[0].replace(" ", "-").replace(",", "")


def _inputs(P, M, N, D, seed=0):
    rng = np.random.default_rng(seed)
    X = make_paths(rng, 3, M, D, scale=0.6)
    Y = make_paths(rng, 4, N, D, scale=0.6)
    ii = rng.integers(0, 3, P)
    jj = rng.integers(0, 4, P)
    ct = rng.normal(size=(P, M - 1, N - 1))
    return X, Y, ii, jj, ct


def _jax(X, Y, ii, jj, ct):
    ds, dx, dy = df_prep.rbf_dd_vjp(jnp.asarray(X[ii]), jnp.asarray(Y[jj]),
                                    _SIGMA, jnp.asarray(ct), False)
    dX, dY = np.zeros_like(X), np.zeros_like(Y)
    np.add.at(dX, ii, np.asarray(dx))
    np.add.at(dY, jj, np.asarray(dy))
    return float(ds), dX, dY


def _sigma_scale(X, Y, ii, jj, ct):
    """sum |E D| / sigma^2 in float64: the magnitude d sigma's terms add
    up to."""
    x, y = X[ii], Y[jj]
    dist = ((x[:, :, None, :] - y[:, None, :, :]) ** 2).sum(-1)
    pad = np.pad(ct, ((0, 0), (1, 1), (1, 1)))
    dG = pad[:, 1:, 1:] + pad[:, :-1, :-1] - pad[:, 1:, :-1] - pad[:, :-1, 1:]
    return float(np.abs(dG * np.exp(-dist / _SIGMA) * dist).sum()
                 / _SIGMA ** 2)


@functools.lru_cache(maxsize=None)
def _references(P, M, N, D):
    """JAX's and the plain version's (d sigma, dX, dY) in float64, and
    d sigma's scale, for :func:`_inputs`."""
    X, Y, ii, jj, ct = _inputs(P, M, N, D)
    plain = incvjp.rbf_dd_vjp_plain(torch.tensor(X), torch.tensor(Y),
                                    torch.tensor(ii), torch.tensor(jj),
                                    _SIGMA, torch.tensor(ct))
    return ((_jax(X, Y, ii, jj, ct), tuple(w.numpy() for w in plain)),
            _sigma_scale(X, Y, ii, jj, ct))


def _run(dtype, X, Y, ii, jj, ct, band, **controls):
    t = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
    return incvjp.rbf_dd_vjp_tiled_plain(t(X), t(Y), torch.tensor(ii),
                                         torch.tensor(jj), _SIGMA, t(ct),
                                         band=band, **controls)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", _CASES, ids=_case_id)
def test_tiled_vjp_matches_plain_and_jax(case, dtype):
    _, P, M, N, D, band = case
    X, Y, ii, jj, ct = _inputs(P, M, N, D)
    got = _run(dtype, X, Y, ii, jj, ct, band)
    assert all(g.dtype == dtype for g in got)
    refs, scale = _references(P, M, N, D)
    for want in refs:
        for n, g, w in zip(("dsigma", "dX", "dY"), got, want):
            g, w = g.double().numpy(), np.asarray(w)
            assert g.shape == w.shape
            ref = (scale if n == "dsigma" and dtype == torch.float32
                   else np.abs(w).max())
            assert np.abs(g - w).max() <= _BARS[dtype] * ref, n


def _changes(a, b):
    return any(not torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("control", ["west_halo", "north_halo"])
@pytest.mark.parametrize("case", _CASES, ids=_case_id)
def test_negative_controls_break_the_emulation(case, control):
    """A halo read as 0 changes the result exactly where the kernel reads
    one: a warp's first column past column 0 (N above one warp's columns),
    a band's first row past row 0 (M above one band)."""
    _, P, M, N, D, band = case
    X, Y, ii, jj, ct = _inputs(P, M, N, D)
    H = band or incvjp.band_rows(D, 8)
    reads = (N > 32 * incvjp.lane_columns(D) if control == "west_halo"
             else M > H)
    got = _run(torch.float64, X, Y, ii, jj, ct, band)
    broken = _run(torch.float64, X, Y, ii, jj, ct, band, **{control: False})
    assert _changes(got, broken) == reads


def test_scatter_and_cpu_routes(rng):
    """``rbf_dd_vjp_tiled_plain`` is the per-pair emulation scattered with
    ``index_add_``; on CPU tensors ``rbf_dd_vjp_pairs`` is the emulation and
    ``rbf_dd_vjp`` the plain version, each counted as a plain call."""
    X, Y, ii, jj, ct = (torch.tensor(a) for a in _inputs(6, 9, 12, 3))
    ds, dx, dy = incvjp.rbf_dd_vjp_pairs_tiled_plain(X, Y, ii, jj, 0.7, ct)
    before = dict(incvjp.COUNTS)
    got = incvjp.rbf_dd_vjp_pairs(X, Y, ii, jj, 0.7, ct)
    assert all(torch.equal(g, w) for g, w in zip(got, (ds, dx, dy)))
    full = incvjp.rbf_dd_vjp_tiled_plain(X, Y, ii, jj, 0.7, ct)
    assert torch.equal(full[0], ds)
    assert torch.equal(full[1], torch.zeros_like(X).index_add_(0, ii, dx))
    assert torch.equal(full[2], torch.zeros_like(Y).index_add_(0, jj, dy))
    incvjp.rbf_dd_vjp(X, Y, ii, jj, 0.7, ct)
    assert incvjp.COUNTS["plain"] == before["plain"] + 3
    assert incvjp.COUNTS["float64"] == before["float64"]


def test_wrapper_constants_are_the_kernels():
    """``WARPS``, ``REGISTER_DIM``, the lane's columns and the shared
    memory the band rows are fitted to are those of ``rbf_dd_vjp.cu``."""
    src = (Path(incvjp.__file__).resolve().parent.parent / "csrc"
           / "rbf_dd_vjp.cu").read_text()
    const = dict(re.findall(r"constexpr int (kVjp\w+) = (\d+);", src))
    assert int(const["kVjpWarps"]) == incvjp.WARPS
    assert int(const["kVjpRegD"]) == incvjp.REGISTER_DIM
    assert int(const["kVjpStages"]) == incvjp.STAGES
    assert "return kD > 0 ? 4 : 1;" in src
    assert [incvjp.lane_columns(D) for D in (1, 8, 9, 300)] == [4, 4, 1, 1]
    assert "kVjpWarps * kVjpStages * (32 * lane_cols + 1)" in src
    assert "h * (kVjpWarps + 1) * (D + 1) + kVjpWarps + rings" in src
    assert "h * (kVjpThreads + 1) + h + kVjpWarps + rings" in src


@pytest.fixture
def posing_as_cuda(monkeypatch):
    """Meta tensors pass K4's checks; each launch and the scratch it gets
    are recorded (not run)."""
    seen = {"launches": [], "scratch": []}
    monkeypatch.setattr(cuda_gen, "check_pairs",
                        lambda X, Y, ii, jj, what, in_range=False: (ii, jj))
    monkeypatch.setattr(_build, "launch", lambda what, fns, counts, t, *args,
                        key=None: seen["launches"].append((fns, args)))
    scratch = incvjp._scratch

    def recorded(*args):
        out = scratch(*args)
        seen["scratch"].append(out)
        return out

    monkeypatch.setattr(incvjp, "_scratch", recorded)
    return seen


def _meta(P, M, N, D, dtype):
    new = lambda *s: torch.empty(*s, device="meta", dtype=dtype)  # noqa: E731
    ii = torch.empty(P, device="meta", dtype=torch.int64)
    return new(2, M, D), new(3, N, D), ii, ii, new(P, M - 1, N - 1)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("D", [1, 3, 8, 9, 300, 1000])
def test_no_dimension_bound_on_the_card(posing_as_cuda, dtype, D):
    """Every D passes the wrapper's checks (the earlier kernel refused D >
    226 in double, 452 in float): one launch, the partials (pairs a launch,
    bands, D + 1, N) and the E * D (P, bands + 1) in the kernel's layout."""
    P, M, N = 4, 150, 60
    X, Y, ii, jj, ct = _meta(P, M, N, D, dtype)
    ds, dX, dY = incvjp.rbf_dd_vjp(X, Y, ii, jj, 0.5, ct)
    assert (ds.shape, dX.shape, dY.shape) == ((), X.shape, Y.shape)
    (fns, args), = posing_as_cuda["launches"]
    (dx, dy, dsig, part, es), (H, chunk) = posing_as_cuda["scratch"][0]
    s = torch.empty((), dtype=dtype).element_size()
    assert fns is incvjp._FNS and H == incvjp.band_rows(D, s)
    assert H == 64 and chunk == P
    nb = -(-M // H)
    assert (dx.shape, dy.shape, dsig.shape) == ((P, M, D), (P, N, D), (1,))
    assert part.shape == (chunk, nb, D + 1, N) and es.shape == (P, nb + 1)
    assert args[10:] == (P, M, N, D, 0.5, H, chunk)
    assert incvjp._smem_bytes(D, H, s) <= _build.SMEM_BYTES


def test_partials_split_by_the_scratch_bound(posing_as_cuda, monkeypatch):
    """With the scratch bound cut to two pairs' partials, the one launch
    takes pairs two at a time; the partials stay within ~10 % of ct's bytes
    at the north star's length and D 3."""
    P, M, N, D = 5, 150, 60, 3
    per_pair = 3 * (D + 1) * N * 8
    monkeypatch.setattr(cuda_gen, "SCRATCH_BYTES", 2 * per_pair + 7)
    X, Y, ii, jj, ct = _meta(P, M, N, D, torch.float64)
    incvjp.rbf_dd_vjp(X, Y, ii, jj, 0.5, ct)
    (_, args), = posing_as_cuda["launches"]
    (_, _, _, part, es), (H, chunk) = posing_as_cuda["scratch"][0]
    assert chunk == 2 and args[-1] == 2 and part.shape == (2, 3, D + 1, N)
    assert es.shape == (P, 4)
    H, nb, _ = incvjp.partials(128, 1024, 1024, 3, 8)
    assert nb * (3 + 1) * 1024 <= 0.1 * 1023 * 1023


def test_band_rows_fit_shared_memory(monkeypatch):
    """Past the register width the band holds its W in shared memory: at
    BAND_ROWS 128 in double that needs more than a block has, so the band
    is halved; within it the band stays BAND_ROWS."""
    monkeypatch.setattr(incvjp, "BAND_ROWS", 128)
    assert incvjp.band_rows(3, 8) == 128
    assert incvjp.band_rows(300, 4) == 128
    assert incvjp.band_rows(300, 8) == 64
