"""K3<gen> on the band-pipelined wavefront (``csrc/band_sweep.cuh``'s
kBandAdjoint mode with ``csrc/rbf_gen.cuh``'s RbfSource walking the base
columns backward), emulated in plain PyTorch by
``cuda_gen.rbf_gen_adjoint_banded_plain``: each pair's reverse frame swept
in bands of ``H`` rows and chunks of ``Wc`` columns from a row 0 of 1s, the
reverse increments generated by the kernel's lane arithmetic (a base row a
lane, G cached one base column to the right, the columns generated on the
warp-uniform steps ahead of their use, last to first), each cell's product
with K1-stack's stack and the collapse run lane by lane in the kernel's
order into ``ct`` in the pairs' own frame (transposed when ``M > N``). It
must equal the plain version (``rbf_gen_adjoint_plain``) bit for bit over
both dtypes, both schemes, dyadic orders 0-3 and 5, ``M < N``, ``M == N``
and ``M > N``, D in {1, 3, 5}, frames of 1, 31, 32, 33, 128 and 129 rows,
and bands and chunks small enough that many of each run; and, through the
gradient chain, JAX's ``sig_gram_lincomb`` on its scan tier. Past ``f = 32``
the wrapper takes the one-block kernel.

The band kernel stores each base cell once, finished: its sum times ``1 /
f^2`` and times the pair's weight ``g`` (RbfFoldSource). With ``g`` the
emulation must equal the plain version times ``g`` bit for bit over the
same cases, with weights that hold zeros, negatives and a subnormal; from a
NaN-filled output it leaves no NaN (every base cell is written, none read).

These tests catch a broken reverse generator. Each of these mutations of
``_lane_increments`` made all 48 cases of
``test_banded_k3_gen_is_the_plain_k3_gen`` with R > 1 fail: the columns
walked forward (the unflipped walk under ``flip``), the cache left one base
column off (the cached G values not updated after a column), and the two
rows' G values swapped (g0 for g1 in the increment). The 4 cases at R 1
pass under each: a one-row frame's gradient is K[0][j] K_rev[0][C-1-j],
the two boundary rows of 1s, and reads no increment.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigkernel_tpu as sk

import sigkernel_tpu_torch as skt
from sigkernel_tpu_torch.ops import _build, band, cuda_gen, routes

from conftest import make_paths
from test_torch_band_gen import _inputs

# (M, N, D, index arrays, dyadic, H, Wc): the frame's rows R = (min(M, N) -
# 1) 2^dyadic, transposed in the kernel's frame when M > N; bands of H rows
# and chunks of Wc columns, the last ones short on most frames; (128, 32)
# are the kernel's own sizes
_CASES = [
    (2, 6, 1, "identity", 0, 16, 8),    # R 1
    (32, 40, 3, "flipped", 0, 16, 8),   # R 31
    (33, 35, 1, "triu", 0, 8, 13),      # R 32
    (34, 36, 5, "identity", 0, 16, 8),  # R 33
    (65, 70, 3, "flipped", 1, 32, 13),  # R 128: one full band of the kernel
    (130, 132, 3, "identity", 0, 128, 32),  # R 129: a band of one row
    (6, 6, 3, "triu", 2, 8, 5),         # M == N
    (9, 5, 5, "flipped", 1, 16, 8),     # M > N: transposed
    (11, 6, 1, "triu", 2, 8, 13),       # M > N
    (4, 7, 5, "identity", 3, 16, 8),    # dyadic 3
    (6, 4, 3, "flipped", 3, 16, 13),    # dyadic 3, transposed
    (3, 4, 3, "identity", 5, 32, 13),   # dyadic 5: a base row is a warp
    (4, 3, 1, "triu", 5, 16, 8),        # dyadic 5, transposed
]


def _case_id(case):
    return "-".join(map(str, case))


@pytest.mark.parametrize("case", _CASES, ids=_case_id)
@pytest.mark.parametrize("naive", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_banded_k3_gen_is_the_plain_k3_gen(dtype, naive, case):
    M, N, D, kind, dyadic, H, Wc = case
    *_, X, Y, ii, jj = _inputs(M, N, D, kind, dtype, M + N)
    _, stack = cuda_gen.rbf_gen_solve_stack_plain(X, Y, ii, jj, 0.6, dyadic,
                                                  naive)
    got = cuda_gen.rbf_gen_adjoint_banded_plain(X, Y, ii, jj, 0.6, stack,
                                                dyadic, naive, H, Wc)
    want = cuda_gen.rbf_gen_adjoint_plain(X, Y, ii, jj, 0.6, stack, dyadic,
                                          naive)
    assert got.dtype == dtype
    assert got.shape == want.shape == (len(ii), M - 1, N - 1)
    assert torch.equal(got, want)


def _weights(P, dtype):
    """Per-pair weights with zeros of both signs, negatives and
    subnormals, cycled over the pairs; any two pairs hold a zero, a
    negative and a subnormal."""
    tiny = torch.finfo(dtype).tiny / 8  # subnormal in either dtype
    w = torch.tensor([-tiny, 0.0, 0.75, -1.25, -0.0, 3.0, tiny, 1e3],
                     dtype=dtype)
    return w[torch.arange(P) % w.shape[0]]


@pytest.mark.parametrize("case", _CASES, ids=_case_id)
@pytest.mark.parametrize("naive", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_banded_k3_gen_folds_the_weights(dtype, naive, case):
    """With ``g`` the band kernel's store is ``(0 + sum) / f^2 * g[p]``: bit
    for bit the plain version's cotangent times ``g``, the passes the
    kernel's epilogue replaces, and the plain version given ``g``."""
    M, N, D, kind, dyadic, H, Wc = case
    *_, X, Y, ii, jj = _inputs(M, N, D, kind, dtype, M + N)
    _, stack = cuda_gen.rbf_gen_solve_stack_plain(X, Y, ii, jj, 0.6, dyadic,
                                                  naive)
    g = _weights(len(ii), dtype)
    assert g[1] == 0 and 0 > g[0] > -torch.finfo(dtype).tiny
    got = cuda_gen.rbf_gen_adjoint_banded_plain(X, Y, ii, jj, 0.6, stack,
                                                dyadic, naive, H, Wc, g=g)
    unweighted = cuda_gen.rbf_gen_adjoint_plain(X, Y, ii, jj, 0.6, stack,
                                                dyadic, naive)
    assert got.dtype == dtype and got.shape == unweighted.shape
    assert torch.equal(got, unweighted * g[:, None, None])
    assert torch.equal(got, cuda_gen.rbf_gen_adjoint_plain(
        X, Y, ii, jj, 0.6, stack, dyadic, naive, g))


@pytest.mark.parametrize("case", _CASES[::3], ids=_case_id)
def test_the_folded_collapse_writes_every_base_cell(case):
    """From a NaN-filled cotangent, the folded collapse
    (``banded_adjoint``'s ``fold``) leaves no NaN and the plain version's
    values, so the kernel's ``torch.empty`` is safe; the adding collapse
    (K3<inc, boundary>'s, K8's) reads the NaN back (the negative
    control)."""
    M, N, D, kind, dyadic, H, Wc = case
    *_, X, Y, ii, jj = _inputs(M, N, D, kind, torch.float64, M + N)
    f = 2 ** dyadic
    _, stack = cuda_gen.rbf_gen_solve_stack_plain(X, Y, ii, jj, 0.6, dyadic)
    u = cuda_gen._lane_increments(X, Y, ii, jj, 0.6, f, flip=True)
    g = _weights(len(ii), torch.float64)
    want = cuda_gen.rbf_gen_adjoint_plain(X, Y, ii, jj, 0.6, stack, dyadic,
                                          g=g)
    for fold in ((1.0 / (f * f), g), None):
        ct = torch.full((len(ii), M - 1, N - 1), float("nan"),
                        dtype=torch.float64)
        out = ct.transpose(-1, -2) if M > N else ct
        band.banded_adjoint(u, stack, u.new_ones(len(ii), u.shape[2] + 1),
                            out, 0, u.shape[1], f, False, H, Wc, fold=fold)
        if fold is None:
            assert ct.isnan().all()
        else:
            assert not ct.isnan().any()
            assert torch.equal(ct, want)


def test_length_one_and_no_pairs():
    """A length-1 path has no increments, no pairs no cotangent: zeros of
    the pairs' frame, as the wrapper returns them."""
    X = torch.zeros(2, 1, 3, dtype=torch.float64)
    Y = torch.ones(2, 4, 3, dtype=torch.float64)
    ii = torch.arange(2)
    ct = cuda_gen.rbf_gen_adjoint_banded_plain(X, Y, ii, ii, 1.0, None, 1)
    assert ct.shape == (2, 0, 3)
    none = torch.zeros(0, dtype=torch.int64)
    assert cuda_gen.rbf_gen_adjoint_banded_plain(
        Y, Y, none, none, 1.0, None).shape == (0, 3, 3)


@pytest.fixture
def banded_gen_chain(monkeypatch):
    """Steer RBF tiles on CPU tensors onto the ``gen`` family, with K3<gen>
    emulated band by band (bands of 8 rows, chunks of 5 columns); yields
    the emulation's call count."""
    orig = routes.resolve_family

    def steered(static_kernel, device_type, solver, **gates):
        if type(static_kernel) is skt.RBFKernel and solver != "scan":
            return "gen"
        return orig(static_kernel, device_type, solver, **gates)

    calls = []
    emulated = functools.partial(cuda_gen.rbf_gen_adjoint_banded_plain,
                                 H=8, Wc=5)

    def adjoint(*args, in_range=False, **kw):
        calls.append(1)
        return emulated(*args, **kw)

    monkeypatch.setattr(routes, "resolve_family", steered)
    monkeypatch.setattr(cuda_gen, "rbf_gen_adjoint", adjoint)
    yield calls


@pytest.mark.parametrize("dyadic", [0, 2])
@pytest.mark.parametrize("M,N", [(6, 9), (9, 6)])
def test_gradient_on_the_band_k3_gen_matches_jax(banded_gen_chain, M, N,
                                                 dyadic):
    """``sig_gram_lincomb``'s gradients in the paths, the weights and sigma
    through K1-stack -> K3<gen> (emulated band by band) -> K4 against
    ``jax.grad`` of the JAX package on its scan tier: float64 within 1e-12
    of max |grad|."""
    rng = np.random.default_rng(20 + M + dyadic)
    X = make_paths(rng, 3, M, 2, scale=0.6)
    Y = make_paths(rng, 4, N, 2, scale=0.6)
    W = rng.normal(size=(3, 4))

    def jloss(x, y, w, s):
        return sk.sig_gram_lincomb(sk.RBFKernel(s), x, y, w,
                                   dyadic_order=dyadic, solver="scan",
                                   pair_chunk=5)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (X, Y, W)), jnp.asarray(0.7))
    x, y, w = (torch.tensor(a, requires_grad=True) for a in (X, Y, W))
    sigma = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    skt.sig_gram_lincomb(skt.RBFKernel(sigma), x, y, w, dyadic_order=dyadic,
                         pair_chunk=5).backward()
    assert banded_gen_chain  # the emulation ran
    for t, wg in zip((x, y, w, sigma), want):
        wg = np.asarray(wg)
        err = np.abs(t.grad.numpy() - wg).max()
        assert err <= 1e-12 * np.abs(wg).max()


@pytest.fixture
def posing_as_cuda(monkeypatch):
    """Meta tensors stand in for CUDA ones: the pair check passes and each
    launch is recorded, ``(name, fns, key, args)``, and counted as
    ``_build.launch`` counts it, instead of run."""
    launches = []

    def launch(what, fns, counts, t, *args, key=None):
        launches.append((what, fns, key, args))
        counts[key or _build.dtype_key(t)] += 1

    monkeypatch.setattr(cuda_gen, "check_pairs",
                        lambda X, Y, ii, jj, what, in_range=False: (ii, jj))
    monkeypatch.setattr(_build, "launch", launch)
    return launches


def _meta(M, N, dyadic, P=2):
    f = 2 ** dyadic
    X = torch.empty(3, M, 2, device="meta", dtype=torch.float64)
    Y = torch.empty(3, N, 2, device="meta", dtype=torch.float64)
    ii = torch.zeros(P, dtype=torch.int64, device="meta")
    R, C = (min(M, N) - 1) * f, (max(M, N) - 1) * f
    stack = torch.empty(P, R + C + 1, R + 1, device="meta",
                        dtype=torch.float64)
    return X, Y, ii, stack


def test_f_past_a_warp_takes_the_one_block_kernel(posing_as_cuda,
                                                  monkeypatch):
    """The route rule: the band kernel while a base row's f rows fit one
    warp (counted under the dtype), the one-block kernel past it (under
    ``"one_block"``, and only there the row bound); the band launch passes
    the pairs' orientation just before the scheme; the emulation refuses
    what the band kernel cannot run."""
    assert [band.adjoint_kernel(d) for d in range(8)] == (
        ["band"] * 6 + ["one_block"] * 2)
    assert "one_block" in cuda_gen.ADJOINT_COUNTS
    monkeypatch.setattr(_build, "max_rows", lambda itemsize: 150)
    for M, N, dyadic, transposed in [(9, 6, 5, 1), (6, 9, 1, 0),
                                     (3, 4, 6, 0)]:
        X, Y, ii, stack = _meta(M, N, dyadic)
        ct = cuda_gen.rbf_gen_adjoint(X, Y, ii, ii, 1.0, stack, dyadic, True)
        assert ct.shape == (2, M - 1, N - 1)
        what, fns, key, args = posing_as_cuda.pop()
        if dyadic <= 5:  # the band kernel, past the row bound (R 160)
            assert fns is cuda_gen._ADJOINT_FNS and key is None
            assert args[-2:] == (transposed, 1)
        else:
            assert fns is cuda_gen._ONE_BLOCK_FNS and key == "one_block"
    X, Y, ii, stack = _meta(3, 4, 7)  # R 256: past the one-block row bound
    with pytest.raises(ValueError, match="shared memory"):
        cuda_gen.rbf_gen_adjoint(X, Y, ii, ii, 1.0, stack, 7)
    X, Y, ii, _ = _inputs(3, 4, 2, "identity", torch.float64, 0)[4:]
    with pytest.raises(ValueError, match="one warp"):
        cuda_gen.rbf_gen_adjoint_banded_plain(X, Y, ii, ii, 1.0, None, 6)


def test_folded_epilogues_are_counted(posing_as_cuda):
    """Where K3<gen>'s scale and weights were applied, read from
    ``ADJOINT_COUNTS``: in the band kernel (its dtype key, dyadic 0-5),
    which takes the weights' pointer, or in PyTorch after the one-block
    kernel (``one_block``, dyadic 6), which takes none; a call with nothing
    to launch counts nothing; a weight of the wrong shape is refused."""
    for dyadic, key in ((1, "float64"), (5, "float64"), (6, "one_block")):
        X, Y, ii, stack = _meta(4, 3, dyadic)
        g = torch.empty(4, device="meta", dtype=torch.float64)[2:]
        before = dict(cuda_gen.ADJOINT_COUNTS)
        ct = cuda_gen.rbf_gen_adjoint(X, Y, ii, ii, 1.0, stack, dyadic, g=g)
        assert ct.shape == (2, 3, 2)
        assert {k: v - before[k] for k, v in
                cuda_gen.ADJOINT_COUNTS.items()} == {
                    k: int(k == key) for k in before}
        what, fns, _, args = posing_as_cuda.pop()
        assert (fns is cuda_gen._ADJOINT_FNS) == (key == "float64")
        assert (args[5] == g.data_ptr() == 16) == (key == "float64")
    before = dict(cuda_gen.ADJOINT_COUNTS)
    X, Y, ii, _ = _meta(1, 3, 1)
    cuda_gen.rbf_gen_adjoint(X, Y, ii, ii, 1.0, None, 1)
    assert cuda_gen.ADJOINT_COUNTS == before and not posing_as_cuda
    X, Y, ii, stack = _meta(4, 3, 1)
    with pytest.raises(ValueError, match="g must be"):
        cuda_gen.rbf_gen_adjoint(X, Y, ii, ii, 1.0, stack, 1,
                                 g=torch.ones(3, device="meta",
                                              dtype=torch.float64))


def test_north_star_backward_folds_every_chunk(posing_as_cuda, monkeypatch):
    """At the north star's shape (10,000 pairs of length 1024, dim 3, dyadic
    1) the generator's backward runs 79 chunks of at most 128 pairs, and
    each K3<gen> launch gets its chunk's weights (the band kernel's
    epilogue, counted under the dtype's key, none under ``one_block``),
    with no multiply after it."""
    from sigkernel_tpu_torch import sigkernel

    monkeypatch.setattr(sigkernel.incvjp, "rbf_dd_vjp",
                        lambda X, Y, ii, jj, sigma, ct, in_range=False: (
                            X.new_zeros(()), torch.zeros_like(X),
                            torch.zeros_like(Y)))
    X = torch.empty(100, 1024, 3, device="meta", dtype=torch.float64)
    P = 10_000
    ii = torch.zeros(P, dtype=torch.int64, device="meta")
    g = torch.empty(P, device="meta", dtype=torch.float64)
    before = dict(cuda_gen.ADJOINT_COUNTS)
    sigkernel._gen_backward(X, X, ii, ii, 1.0, g, torch.float64, 1, False)
    assert {k: v - before[k] for k, v in
            cuda_gen.ADJOINT_COUNTS.items()} == {
                "float32": 0, "float64": 79, "one_block": 0, "plain": 0}
    wts = [args[5] for what, _, _, args in posing_as_cuda
           if what == "adjoint_collapse_gen"]
    assert wts == [g.data_ptr() + 8 * 128 * k for k in range(79)]
