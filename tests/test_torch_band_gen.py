"""K1 and K1-stack on the band-pipelined wavefront (``csrc/band_sweep.cuh``
with ``csrc/rbf_gen.cuh``'s RbfSource), emulated in plain PyTorch by
``cuda_gen.rbf_gen_banded_plain`` and ``rbf_gen_banded_stack_plain``: each
pair's frame swept in bands of ``H`` rows and chunks of ``Wc`` columns from a
row 0 of 1s, the increments generated by the kernel's lane arithmetic (a
base row a lane, G cached one base column back, the columns generated on
the warp-uniform steps ahead of their use, the pair transposed when ``M >
N``). It must equal the plain versions (``rbf_gen_solve_final_plain``,
``rbf_gen_solve_stack_plain``) bit for bit over both dtypes, both schemes,
dyadic orders 0-3, ``M < N``, ``M == N`` and ``M > N``, D in {1, 3, 5},
frames of fewer than 32 rows and of a row count that is no multiple of the
band height, and identity, flipped and ``triu`` index arrays; and, on the
same numpy inputs, the JAX package's scan tier within 1e-12 relative.

These tests catch a broken generator. Each of these mutations of
``_lane_increments`` made all 96 cases of ``test_banded_k1_is_the_plain_k1``
fail: G cached one base column off (the cache left as it was after each
column), g00 and g10 swapped (the two rows' cached values), a column
generated every 2 f steps (the lanes starve), or generated on every
uniform step whatever the lane holds in reserve (columns skipped). Two
mutations change nothing, and no test can see them: swapping g10 with g01
(they enter the increment only through ``g10 + g01``, a sum that is exact
in either order), and another phase of the uniform steps (``s % f == 1``:
any phase leaves one such step between two wraps of a lane).

On meta tensors posing as the card's, the generator family's estimators
read nothing on the host between their launches: their index arrays pass
as built, with no read of their bounds, and sigma, held on the card, is read
once before the launches it serves and reaches each of them by value; only
index arrays a caller passes to an entry directly have their bounds read.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigkernel_tpu as sk

from sigkernel_tpu_torch.ops import band, cuda_gen

from conftest import make_paths

# (M, N, D, index arrays, H, Wc): the shorter path's refined rows R = (min(M,
# N) - 1) 2^dyadic, transposed in the kernel's frame when M > N. Bands of 16
# rows and chunks of 8 columns put several bands and chunks, the last ones
# short, on every frame past dyadic 1; (128, 32) are the kernel's own sizes
# (one short band).
_CASES = [
    (4, 7, 1, "identity", 16, 8),   # R = 3 .. 24: fewer than 32 rows
    (6, 6, 3, "triu", 16, 8),       # M == N, R = 5 .. 40
    (8, 5, 5, "flipped", 16, 8),    # M > N: transposed, R = 4 .. 32
    (5, 9, 3, "flipped", 128, 32),  # the kernel's band and chunk
    (9, 5, 1, "triu", 8, 13),       # M > N, an odd chunk
    (6, 11, 5, "identity", 16, 8),
]


def _case_id(case):
    return "-".join(map(str, case))


def _pairs(kind, A, B):
    if kind == "identity":
        n = min(A, B)
        return np.arange(n), np.arange(n)
    if kind == "flipped":
        n = min(A, B)
        return np.arange(n), np.arange(n)[::-1].copy()
    ii, jj = np.triu_indices(min(A, B))
    return ii, jj


def _inputs(M, N, D, kind, dtype, seed):
    rng = np.random.default_rng(seed)
    X = make_paths(rng, 3, M, D, scale=0.8)
    Y = make_paths(rng, 4, N, D, scale=0.8)
    ii, jj = _pairs(kind, 3, 4)
    t = [torch.tensor(a, dtype=dtype) for a in (X, Y)]
    return (X, Y, ii, jj, *t, torch.tensor(ii), torch.tensor(jj))


@pytest.mark.parametrize("case", _CASES, ids=_case_id)
@pytest.mark.parametrize("dyadic", [0, 1, 2, 3])
@pytest.mark.parametrize("naive", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_banded_k1_is_the_plain_k1(dtype, naive, dyadic, case):
    M, N, D, kind, H, Wc = case
    *_, X, Y, ii, jj = _inputs(M, N, D, kind, dtype, 0)
    got = cuda_gen.rbf_gen_banded_plain(X, Y, ii, jj, 0.6, dyadic, naive, H,
                                        Wc)
    want = cuda_gen.rbf_gen_solve_final_plain(X, Y, ii, jj, 0.6, dyadic,
                                              naive)
    assert got.dtype == dtype and got.shape == want.shape == (len(ii),)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", _CASES[:3], ids=_case_id)
@pytest.mark.parametrize("dyadic", [0, 1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_banded_k1_stack_is_the_plain_stack(dtype, dyadic, case):
    """Every entry of K1-stack's stack as the band kernel writes it: row 0
    the constant 1 to column C, the swept cells on their diagonals, 1 at
    column 0, 0 outside; and the values."""
    M, N, D, kind, H, Wc = case
    *_, X, Y, ii, jj = _inputs(M, N, D, kind, dtype, 1)
    naive = dyadic % 2 == 1
    got = cuda_gen.rbf_gen_banded_stack_plain(X, Y, ii, jj, 0.6, dyadic,
                                              naive, H, Wc)
    want = cuda_gen.rbf_gen_solve_stack_plain(X, Y, ii, jj, 0.6, dyadic,
                                              naive)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


def test_length_one_and_no_pairs():
    """A length-1 path: K is its boundary, 1; no pairs: no values."""
    X = torch.zeros(2, 1, 3, dtype=torch.float64)
    Y = torch.ones(2, 4, 3, dtype=torch.float64)
    ii = torch.arange(2)
    assert torch.equal(cuda_gen.rbf_gen_banded_plain(X, Y, ii, ii, 1.0, 1),
                       torch.ones(2, dtype=torch.float64))
    none = torch.zeros(0, dtype=torch.int64)
    assert cuda_gen.rbf_gen_banded_plain(Y, Y, none, none, 1.0).shape == (0,)


@pytest.mark.parametrize("case", _CASES[:3], ids=_case_id)
@pytest.mark.parametrize("dyadic", [0, 2])
def test_banded_k1_matches_jax_scan_tier(dyadic, case):
    """The JAX package's RBF Gram on its scan tier, at the same pairs of the
    same numpy paths, float64 within 1e-12 relative."""
    M, N, D, kind, H, Wc = case
    Xn, Yn, iin, jjn, X, Y, ii, jj = _inputs(M, N, D, kind, torch.float64, 2)
    gram = np.asarray(sk.sig_gram(sk.RBFKernel(0.6), jnp.asarray(Xn),
                                  jnp.asarray(Yn), dyadic_order=dyadic,
                                  solver="scan"))
    got = cuda_gen.rbf_gen_banded_plain(X, Y, ii, jj, 0.6, dyadic, False, H,
                                        Wc).numpy()
    np.testing.assert_allclose(got, gram[iin, jjn], rtol=1e-12, atol=0)


# ---- no host read between the generator family's launches ---------------


@pytest.fixture
def meta_card(monkeypatch):
    """Meta tensors stand in for CUDA ones: they pass the layout checks
    (``cuda_gen.check_layout``) while ``check_pairs`` runs as it is; RBF
    tiles take the generator's family; each launch is recorded, ``(name,
    args)``, not run; each host read (``tracing.host``) is recorded by its
    site, reads sigma as 0.5 and bounds in range; ``events`` holds both in
    order."""
    from sigkernel_tpu_torch import tracing
    from sigkernel_tpu_torch.ops import routes

    seen = {"launches": [], "reads": [], "events": []}

    def read(t, site):
        seen["reads"].append(site)
        seen["events"].append(("read", site))
        return 0.5 if t.dim() == 0 else [0] * t.numel()

    def launch(what, fns, counts, t, *args, key=None):
        seen["launches"].append((what, args))
        seen["events"].append(("launch", what))

    orig = routes.resolve_family

    def steered(static_kernel, device_type, solver, **gates):
        if device_type == "meta":
            return "gen"
        return orig(static_kernel, device_type, solver, **gates)

    monkeypatch.setattr(cuda_gen, "check_layout",
                        lambda X, Y, ii, jj, what: (ii, jj))
    monkeypatch.setattr(cuda_gen._build, "launch", launch)
    monkeypatch.setattr(cuda_gen, "host", read)
    monkeypatch.setattr(tracing, "host", read)
    monkeypatch.setattr(routes, "resolve_family", steered)
    return seen


def _meta_paths(batch, length, grad=False, D=3):
    return torch.empty(batch, length, D, device="meta", dtype=torch.float64,
                       requires_grad=grad)


def _meta_sigma():
    return torch.empty((), device="meta", dtype=torch.float64,
                       requires_grad=True)


def _lincomb():
    """``sig_gram_lincomb`` fwd + bwd, 5 x 4 paths, 6 pairs a chunk (the
    last short), X, Y, W and sigma requiring gradients."""
    import sigkernel_tpu_torch as skt

    X, Y = _meta_paths(5, 9, True), _meta_paths(4, 7, True)
    W = torch.empty(5, 4, device="meta", dtype=torch.float64,
                    requires_grad=True)
    skt.sig_gram_lincomb(skt.RBFKernel(_meta_sigma()), X, Y, W,
                         dyadic_order=1, pair_chunk=6).backward()


def _gram_sym():
    """``sig_gram(sym=True)`` of 7 paths, 4 pairs a chunk: the triangle's 28
    pairs in 7 chunks; sigma a number, held on the host."""
    import sigkernel_tpu_torch as skt

    X = _meta_paths(7, 6)
    skt.sig_gram(skt.RBFKernel(0.5), X, X, dyadic_order=1, sym=True,
                 max_batch=2)


def _gram_tiles():
    """``sig_gram`` of 5 x 7 paths in ragged tiles of 3 (2 x 3 tiles);
    sigma on the card."""
    import sigkernel_tpu_torch as skt

    skt.sig_gram(skt.RBFKernel(_meta_sigma().detach()), _meta_paths(5, 6),
                 _meta_paths(7, 8), max_batch=3)


def _rbf_gen_backward():
    """``sig_kernel`` fwd + bwd in X and sigma: ``_RBFGen``'s forward (K1)
    and its backward (K1-stack, K3<gen>, K4)."""
    import sigkernel_tpu_torch as skt

    skt.sig_kernel(skt.RBFKernel(_meta_sigma()), _meta_paths(4, 6, True),
                   _meta_paths(4, 5), dyadic_order=2).sum().backward()


# call: (its kernels, its reads of sigma: one a lincomb, one a tile, none
# for a sigma held on the host)
ESTIMATOR_CALLS = {
    "lincomb": (_lincomb, {"rbf_gen_stack", "adjoint_collapse_gen",
                           "rbf_dd_vjp"}, 1),
    "gram_sym": (_gram_sym, {"rbf_gen_wavefront"}, 0),
    "gram_tiles": (_gram_tiles, {"rbf_gen_wavefront"}, 6),
    "rbf_gen_backward": (_rbf_gen_backward, {
        "rbf_gen_wavefront", "rbf_gen_stack", "adjoint_collapse_gen",
        "rbf_dd_vjp"}, 1),
}


@pytest.mark.parametrize("call", sorted(ESTIMATOR_CALLS))
def test_estimators_read_nothing_between_their_launches(meta_card, call):
    """Each launch of an estimator's call takes index arrays the estimator
    built, whose bounds it does not read, and sigma by value. Sigma on the
    card is read once before the launches it serves (the lincomb's all, a
    Gram tile's, the forward's and the backward's of ``_RBFGen``), never
    between them; the bounds never."""
    fn, kernels, reads = ESTIMATOR_CALLS[call]
    fn()
    launches = meta_card["launches"]
    assert {what for what, _ in launches} == kernels
    assert meta_card["reads"] == ["sigma"] * reads
    groups = max(reads, 1)
    serves = len(launches) // groups
    assert [kind for kind, _ in meta_card["events"]] == (
        ["read"] * (reads > 0) + ["launch"] * serves) * groups


def _entries(X, Y, ii, stacks, ct):
    """The launching entries of the generator family on meta inputs, each
    a function of sigma and the keywords; K3<gen> at dyadic 1 (the band
    kernel) and 6 (the one-block kernel)."""
    from sigkernel_tpu_torch.ops import incvjp

    return {
        "rbf_gen_solve_final": lambda s, **kw: cuda_gen.rbf_gen_solve_final(
            X, Y, ii, ii, s, 1, **kw),
        "rbf_gen_solve_stack": lambda s, **kw: cuda_gen.rbf_gen_solve_stack(
            X, Y, ii, ii, s, 1, **kw),
        "rbf_gen_adjoint": lambda s, **kw: cuda_gen.rbf_gen_adjoint(
            X, Y, ii, ii, s, stacks[1], 1, **kw),
        "rbf_gen_adjoint[one block]": lambda s, **kw:
            cuda_gen.rbf_gen_adjoint(X, Y, ii, ii, s, stacks[6], 6, **kw),
        "rbf_dd_vjp": lambda s, **kw: incvjp.rbf_dd_vjp(X, Y, ii, ii, s, ct,
                                                        **kw),
        "rbf_gen_increments": lambda s, **kw: cuda_gen.rbf_gen_increments(
            X, Y, ii, ii, s, **kw),
    }


def _meta_entries():
    from sigkernel_tpu_torch.ops.cuda_solver import stack_shape

    X, Y = _meta_paths(4, 6), _meta_paths(3, 5)
    ii = torch.empty(3, device="meta", dtype=torch.int64)
    stacks = {d: torch.empty(stack_shape(3, 5 * 2 ** d, 4 * 2 ** d),
                             device="meta", dtype=torch.float64)
              for d in (1, 6)}
    ct = torch.empty(3, 5, 4, device="meta", dtype=torch.float64)
    return X, Y, ii, stacks, ct


@pytest.mark.parametrize("entry", ["rbf_gen_solve_final",
                                   "rbf_gen_solve_stack", "rbf_gen_adjoint",
                                   "rbf_dd_vjp", "rbf_gen_increments"])
def test_caller_indices_are_read_once(meta_card, monkeypatch, entry):
    """A direct call with the caller's index arrays reads their bounds once
    (``sk.sync.index_bounds``) and still refuses an index out of range;
    with ``in_range=True`` it reads nothing."""
    call = _entries(*_meta_entries())[entry]
    call(0.5)
    assert meta_card["reads"] == ["index_bounds"]
    call(0.5, in_range=True)
    assert meta_card["reads"] == ["index_bounds"]

    def out_of_range(t, site):  # X holds 4 paths
        meta_card["reads"].append(site)
        return [0, 4, 0, 0]

    monkeypatch.setattr(cuda_gen, "host", out_of_range)
    with pytest.raises(ValueError, match="pair index out of range"):
        call(0.5)
    assert meta_card["reads"] == ["index_bounds"] * 2


@pytest.mark.parametrize("sigma", ["number", "host", "card", "card_f32"])
def test_sigma_reaches_each_launch_by_value(meta_card, sigma):
    """Every launching entry of the generator family hands its launch sigma
    as a Python float: a number or a host tensor as it is, with no read of
    the card; a tensor on the card (requiring a gradient) read once a call
    (``sk.sync.sigma``), which the estimators do once for all their
    launches instead."""
    given = {"number": 0.5,
             "host": torch.tensor(0.5, dtype=torch.float32),
             "card": _meta_sigma(),
             "card_f32": torch.empty((), device="meta", dtype=torch.float32,
                                     requires_grad=True)}[sigma]
    reads = ["sigma"] if sigma.startswith("card") else []
    for name, call in _entries(*_meta_entries()).items():
        meta_card["reads"].clear()
        call(given, in_range=True)
        what, args = meta_card["launches"][-1]
        at = {"adjoint_collapse_gen": -4, "rbf_gen_increments": -1}.get(
            what, -3)
        assert type(args[at]) is float and args[at] == 0.5, name
        assert meta_card["reads"] == reads, name


@pytest.mark.parametrize("entry", ["rbf_gen_solve_final",
                                   "rbf_gen_solve_stack", "rbf_gen_adjoint"])
def test_split_launches_read_sigma_once(meta_card, monkeypatch, entry):
    """An entry whose pairs ``band.pairs_a_launch`` splits into a launch a
    pair reads sigma on the card once for all its launches, before the
    first."""
    monkeypatch.setattr(band, "pairs_a_launch",
                        lambda P, R, C, itemsize, values=1: 1)
    _entries(*_meta_entries())[entry](_meta_sigma(), in_range=True)
    assert [kind for kind, _ in meta_card["events"]] == ["read"] + [
        "launch"] * 3


def _kernel(X, Y, **kw):
    import sigkernel_tpu_torch as skt

    return skt.sig_kernel(skt.RBFKernel(_meta_sigma()), X, Y, **kw)


def _compute_kernel(X, Y):
    import sigkernel_tpu_torch as skt

    return skt.SigKernel(skt.RBFKernel(_meta_sigma()), 1).compute_kernel(
        X, Y, max_batch=2)


PAIRWISE_CALLS = {
    "sig_kernel": _kernel,
    "sig_kernel_chunked": functools.partial(_kernel, max_batch=2),
    "compute_kernel": _compute_kernel,
}


@pytest.mark.parametrize("call", sorted(PAIRWISE_CALLS))
@pytest.mark.parametrize("batches", [(5, 3), (3, 5)])
def test_pairwise_batches_of_two_sizes_are_refused(meta_card, call,
                                                   batches):
    """The pairwise estimators pair ``X[i]`` with ``Y[i]`` by indices built
    from ``X``'s batch, which the launches take unchecked: batches of two
    sizes are refused before any launch or host read."""
    X, Y = (_meta_paths(b, 6) for b in batches)
    with pytest.raises(ValueError, match="as many paths"):
        PAIRWISE_CALLS[call](X, Y)
    assert meta_card["events"] == []
