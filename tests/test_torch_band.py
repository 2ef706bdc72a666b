"""The band kernels' launch contract (``ops/band.py``), on meta tensors
posing as CUDA ones, each launch recorded, not run.

All eleven band wrappers (K1, K1-stack, K3<gen>, K2, K2-stack, K2-sparse,
K8, K7, K7-stack, K3<inc, boundary>, K5) launch through ``band.launch``. At
three frames (two bands; three bands, transposed; one band of exactly 128
rows) each must: launch all its pairs at once under the default bounds;
split them 2, 2 and 1 when ``band.SCRATCH_BYTES`` is cut to two pairs'
hand-off rows and counters (one launch still, where one band leaves no
hand-off rows), and when ``band.TICKETS`` is cut to two pairs' blocks;
advance each per-pair pointer by one pair's block of its tensor for every
pair launched before, keep the shared paths' pointers and K3<gen>'s null
weight pointer; pass the pair count and the kernel's scalars (``nbands`` among
them) in the kernel's order; and add its pairs times its swept rows and
its pairs times its bands' 128 rows to ``band.BAND_FILL``, split or not.
``band.pairs_a_launch`` is checked at the cells' shapes.
"""
import math

import pytest
import torch

from sigkernel_tpu_torch.ops import (_build, band, cuda_blocked, cuda_deriv,
                                     cuda_gen, cuda_solver)

P = 5
META = dict(device="meta", dtype=torch.float64)
SIGMA = 0.5


def _t(*shape):
    return torch.empty(*shape, **META)


def _pair_bytes(shape):
    """Bytes of one pair's block of a float64 tensor of ``shape``."""
    return math.prod(shape[1:]) * 8


def _gen(kind, Mb, Nb, d):
    """K1 (``final``), K1-stack (``stack``) or K3<gen> (``adjoint``, with
    weights; ``unweighted``, a null pointer) on paths of ``Mb + 1`` and
    ``Nb + 1`` points: the rows are the shorter path (transposed when ``Mb
    > Nb``), both paths shared by every pair."""
    f = 2 ** d
    X, Y = _t(3, Mb + 1, 3), _t(4, Nb + 1, 3)
    ii = torch.empty(P, device="meta", dtype=torch.int64)
    R, C = band.frame(Mb, Nb, d)
    stack = cuda_solver.stack_shape(P, Mb * f, Nb * f)
    tail = (min(Mb, Nb) + 1, max(Mb, Nb) + 1, 3, f, SIGMA, band.bands(R))
    shared = [(None, 0), (None, 0), (None, 8), (None, 8)]
    if kind == "final":
        return (lambda: cuda_gen.rbf_gen_solve_final(X, Y, ii, ii, SIGMA, d,
                                                     True),
                "sk_rbf_gen_wavefront", shared + [(None, 8)], tail + (1,))
    if kind == "stack":
        return (lambda: cuda_gen.rbf_gen_solve_stack(X, Y, ii, ii, SIGMA, d,
                                                     True),
                "sk_rbf_gen_stack",
                shared + [(None, 8), (None, _pair_bytes(stack))], tail + (1,))
    # weights a pair, at an offset: a pointer of 16
    g, wt = (None, ("null", 0)) if kind == "unweighted" else (_t(P + 2)[2:],
                                                              (16, 8))
    return (lambda: cuda_gen.rbf_gen_adjoint(X, Y, ii, ii, SIGMA, _t(*stack),
                                             d, True, g),
            "sk_adjoint_gen_band",
            shared + [(None, Mb * Nb * 8), wt, (None, _pair_bytes(stack))],
            tail + (int(Mb > Nb), 1))


def _inc(kind, Mb, Nb, d):
    """K2, K2-stack, K2-sparse or K8 over a base grid ``(P, Mb, Nb)``."""
    f = 2 ** d
    inc = _t(P, Mb, Nb)
    R, C = band.frame(Mb, Nb, d)
    W = cuda_solver.window()
    grid = (None, Mb * Nb * 8)
    sparse = cuda_solver.sparse_shape(P, Mb * f, Nb * f)
    if kind == "ckpt":
        return (lambda: cuda_solver.inc_adjoint_ckpt(inc, _t(*sparse), d,
                                                     True),
                "sk_adjoint_ckpt_band",
                [grid, (None, _pair_bytes(sparse)), grid],
                (Mb, Nb, f, W, band.bands(R), 1))
    wrapper, fns, extra, scalars = {
        "final": (cuda_solver.inc_solve_final, "sk_inc_wavefront", [], ()),
        "stack": (cuda_solver.inc_solve_stack, "sk_inc_stack",
                  [(None, _pair_bytes(cuda_solver.stack_shape(
                      P, Mb * f, Nb * f)))], ()),
        "sparse": (cuda_solver.inc_solve_sparse, "sk_inc_sparse",
                   [(None, _pair_bytes(sparse))], (W,)),
    }[kind]
    return (lambda: wrapper(inc, d, True), fns, [grid, (None, 8)] + extra,
            (Mb, Nb, f) + scalars + (band.bands(R), 1))


def _stripe(kind, Mb, Nb, d):
    """K7, K7-stack or K3<inc, boundary> on the stripe of the frame's rows
    ``0 .. R - 1``, flipped for the sweeps."""
    f = 2 ** d
    inc = _t(P, Mb, Nb)
    R, C = band.frame(Mb, Nb, d)
    grid, row = (None, Mb * Nb * 8), (None, (C + 1) * 8)
    bd = _t(P, C + 1)
    stack = cuda_solver.stack_shape(P, R, C)
    scalars = (Mb, Nb, f, 0, R, band.bands(R))
    if kind == "final":
        return (lambda: cuda_blocked.stripe_solve(inc, bd, 0, R, d, True,
                                                  True),
                "sk_stripe", [grid, row, row], scalars + (1, 1))
    if kind == "stack":
        return (lambda: cuda_blocked.stripe_solve_stack(inc, bd, 0, R, d,
                                                        True, True),
                "sk_stripe_stack",
                [grid, row, row, (None, _pair_bytes(stack))],
                scalars + (1, 1))
    return (lambda: cuda_blocked.stripe_adjoint(inc, _t(*stack), bd,
                                                _t(P, Mb, Nb), 0, R, d, True),
            "sk_adjoint_band",
            [grid, (None, _pair_bytes(stack)), row, grid], scalars + (1,))


def _deriv(Mb, Nb, d):
    """K5: three grids, three values a column of scratch."""
    R, _ = band.frame(Mb, Nb, d)
    grid = (None, Mb * Nb * 8)
    return (lambda: cuda_deriv.deriv_solve_final(
                *(_t(P, Mb, Nb) for _ in range(3)), d),
            "sk_deriv_wavefront", [grid] * 3 + [(None, 3 * 8)],
            (Mb, Nb, 2 ** d, band.bands(R)))


# the launch's name (and a case after "/"): (the case's set-up, values a
# scratch column)
WRAPPERS = {
    "rbf_gen_wavefront": (lambda *a: _gen("final", *a), 1),
    "rbf_gen_stack": (lambda *a: _gen("stack", *a), 1),
    "adjoint_collapse_gen": (lambda *a: _gen("adjoint", *a), 1),
    "adjoint_collapse_gen/unweighted": (lambda *a: _gen("unweighted", *a), 1),
    "inc_wavefront": (lambda *a: _inc("final", *a), 1),
    "inc_wavefront[stack]": (lambda *a: _inc("stack", *a), 1),
    "inc_wavefront[sparse]": (lambda *a: _inc("sparse", *a), 1),
    "adjoint_ckpt": (lambda *a: _inc("ckpt", *a), 1),
    "stripe_wavefront": (lambda *a: _stripe("final", *a), 1),
    "stripe_wavefront[stack]": (lambda *a: _stripe("stack", *a), 1),
    "adjoint_collapse_stripe": (lambda *a: _stripe("adjoint", *a), 1),
    "deriv_wavefront": (_deriv, 3),
}
# (Mb, Nb, dyadic): R rows of C columns, nbands
FRAMES = {
    "two_bands": (140, 150, 0),              # R 140, C 150, 2 bands
    "three_bands_transposed": (150, 130, 1),  # R 260, C 300, 3 bands
    "one_band": (64, 100, 1),                 # R 128, C 200, 1 band
}


@pytest.fixture
def posing_as_cuda(monkeypatch):
    """Meta tensors pass every band wrapper's checks, and each launch is
    recorded, ``(name, fns, key, args)``, not run."""
    launches = []
    monkeypatch.setattr(cuda_solver, "_check", lambda inc, what: None)
    monkeypatch.setattr(cuda_deriv, "_check", lambda *grids: None)
    monkeypatch.setattr(cuda_gen, "check_pairs",
                        lambda X, Y, ii, jj, what, in_range=False: (ii, jj))
    monkeypatch.setattr(_build, "launch", lambda what, fns, counts, t, *args,
                        key=None: launches.append((what, fns, key, args)))
    return launches


@pytest.mark.parametrize("bound", ["none", "scratch", "tickets"])
@pytest.mark.parametrize("frame", sorted(FRAMES))
@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_band_launches_split_by_the_bounds(posing_as_cuda, monkeypatch,
                                           name, frame, bound):
    Mb, Nb, d = FRAMES[frame]
    build, values = WRAPPERS[name]
    call, symbol, ptrs, tail = build(Mb, Nb, d)
    R, C = band.frame(Mb, Nb, d)
    nb = band.bands(R)
    split = [2, 2, 1]
    if bound == "scratch":
        per_pair = (nb - 1) * (C + 1) * values * 8 + 4 * nb
        monkeypatch.setattr(band, "SCRATCH_BYTES", 2 * per_pair + 4)
        if nb == 1:  # no hand-off rows: nothing to bound
            split = [P]
    elif bound == "tickets":
        monkeypatch.setattr(band, "TICKETS", 3 * nb - 1)  # two pairs
    else:
        split = [P]
    assert cuda_gen.BAND_FILL is band.BAND_FILL
    before = dict(band.BAND_FILL)
    call()
    assert [(w, f[torch.float64], k) for w, f, k, _ in posing_as_cuda] == [
        (name.split("/")[0], symbol + "_f64", None)] * len(split)
    first = posing_as_cuda[0][3]
    k = len(ptrs)
    s = 0
    for n, (*_, args) in zip(split, posing_as_cuda):
        for j, (at, per) in enumerate(ptrs):
            if at == "null":
                assert args[j] is None
            else:
                assert args[j] == (first[j] if at is None else at) + per * s
        assert args[k + 2:] == (n,) + tail
        s += n
    assert band.BAND_FILL == {"rows": before["rows"] + P * R,
                              "slots": before["slots"] + P * nb * 128}


@pytest.mark.parametrize("P,R,C,itemsize,values,want", [
    (128, 2046, 2046, 8, 1, 128),        # the north star's chunk: one launch
    (10_000, 2046, 2046, 8, 1, 2185),    # the forward Gram's tile, in double
    (10_000, 2046, 2046, 4, 1, 4368),    # ... in float
    (10_000, 2046, 2046, 8, 3, 728),     # K5: three values a column
    (10_000, 8184, 8184, 8, 3, 43),      # K5 at length 1024, dyadic 3
    (126, 4092, 4092, 8, 1, 126),        # K8's chunk at the scoring rule
    (1_000, 4092, 4092, 8, 1, 528),      # ... and the most it allows there
    (5_050, 100, 300, 8, 1, 5_050),      # one band: no scratch at all
    (3_000_000_000, 100, 300, 8, 1, (1 << 31) - 1),  # the ticket bound
    (3, 100_000, 100_000, 8, 1, 1),      # a pair's scratch past the bound
])
def test_pairs_a_launch_keeps_the_scratch_within_its_bound(P, R, C, itemsize,
                                                           values, want):
    n = band.pairs_a_launch(P, R, C, itemsize, values)
    assert n == want
    bands = -(-R // 128)
    # the hand-off rows and the counters (an int a block, and the ticket)
    per_pair = (bands - 1) * (C + 1) * values * itemsize + 4 * bands
    assert band.scratch_bytes(R, C, itemsize, values) == per_pair
    assert n == 1 or bands == 1 or n * per_pair + 4 <= band.SCRATCH_BYTES
    assert n * bands <= band.TICKETS
