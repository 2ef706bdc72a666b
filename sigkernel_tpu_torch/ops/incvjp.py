"""K4: the increment-chain VJP of the RBF generation
(``csrc/rbf_dd_vjp.cu``).

Replaces ``sigkernel_tpu/ops/pallas_incvjp.py`` (``_vjp_kernel``): given the
cotangent ``ct`` ``(P, M-1, N-1)`` of the base increments
``dd(exp(-|x_m - y_n|^2 / sigma))`` of the pairs ``(X[ii[p]], Y[jj[p]])``,
it returns the gradients in ``sigma``, ``X`` and ``Y``. The per-pair path
gradients go back onto ``X`` and ``Y`` with ``index_add_`` over ``ii`` and
``jj``, so one call serves pairwise kernels, Grams, the symmetric triangle
and the linear-combination chunks.

The kernel makes one pass over each pair's (M, N) cells in bands of
:func:`band_rows` rows, a block a band; its sums run in a fixed order, and
:func:`rbf_dd_vjp_pairs_tiled_plain` repeats that order in PyTorch (the
tests and ``chip_smoke.py`` hold the kernel to it bit for bit).

:func:`rbf_dd_vjp` launches the kernel for CUDA tensors and takes
:func:`rbf_dd_vjp_plain` (a port of ``sigkernel_tpu/ops/df_prep.py``'s
``rbf_dd_vjp``, pairwise layout) only for CPU tensors. ``COUNTS`` holds the
kernel launches per dtype (one a call) and the calls of the plain versions.
"""
from __future__ import annotations

import torch

from . import _build, band, cuda_gen
from ..tracing import spanned
from ..utils import dd_transpose

COUNTS = {"float32": 0, "float64": 0, "plain": 0}

_FNS = {torch.float32: "sk_rbf_dd_vjp_f32",
        torch.float64: "sk_rbf_dd_vjp_f64"}
BAND_ROWS = 64     # rows a block (a band); fewer where D > REGISTER_DIM
WARPS = 8          # kVjpWarps in csrc/rbf_dd_vjp.cu
REGISTER_DIM = 8   # kVjpRegD: the widest D held in registers
STAGES = 4         # kVjpStages: rows of ct in flight a warp
_THREADS = 32 * WARPS

# the plain versions run pairs in chunks whose (M, N) grids stay near this
_PLAIN_CHUNK_BYTES = 1 << 30


def lane_columns(D: int) -> int:
    """Columns a lane owns in a chunk: 4 where ``D <= REGISTER_DIM``, else 1
    (``vjp_lane_cols``)."""
    return 4 if D <= REGISTER_DIM else 1


def _smem_bytes(D: int, H: int, itemsize: int) -> int:
    """The band kernel's shared memory (``vjp_smem``)."""
    rings = WARPS * STAGES * (32 * lane_columns(D) + 1)
    if D <= REGISTER_DIM:
        return itemsize * (H * (WARPS + 1) * (D + 1) + WARPS + rings)
    return itemsize * (H * (_THREADS + 1) + H + WARPS + rings)


def band_rows(D: int, itemsize: int) -> int:
    """Rows of a band: :data:`BAND_ROWS`, halved while the kernel's shared
    memory would not fit a block (past ``REGISTER_DIM`` it holds the band's
    W of a chunk)."""
    H = BAND_ROWS
    while H > 1 and _smem_bytes(D, H, itemsize) > _build.SMEM_BYTES:
        H //= 2
    return H


def partials(P: int, M: int, N: int, D: int, itemsize: int):
    """``(H, bands, pairs a launch)``: the band's rows, the bands a pair, and
    the pairs whose column partials ``(pairs, bands, D + 1, N)`` fit
    :data:`.band.SCRATCH_BYTES` (at least one)."""
    H = band_rows(D, itemsize)
    nb = -(-M // H)
    per_pair = nb * (D + 1) * N * itemsize
    return H, nb, max(1, min(P, band.SCRATCH_BYTES // per_pair))


def _sigma(sigma, t) -> torch.Tensor:
    """``sigma`` as a value of ``t``'s dtype, rounded as the kernel rounds
    the double it is given."""
    return torch.as_tensor(cuda_gen.sigma_value(sigma), dtype=t.dtype,
                           device=t.device)


def vjp_pairs_plain(x, y, sigma, ct):
    """The VJP for the pairs ``(x[p], y[p])``: ``(sum over pairs of
    E * D, dx (P, M, D), dy (P, N, D))``, with ``dG = dd^T(ct)``,
    ``E = dG * exp(-D / sigma)``, ``W = -E / sigma``."""
    dG = dd_transpose(ct)
    dist = cuda_gen.sqdist(x, y)
    E = dG * torch.exp(-dist / sigma)
    W = E * (-1.0 / sigma)
    dx = 2.0 * (torch.sum(W, -1)[..., None] * x - torch.bmm(W, y))
    dy = 2.0 * (torch.sum(W, -2)[..., None] * y
                - torch.bmm(W.transpose(-1, -2), x))
    return torch.sum(E * dist), dx, dy


def rbf_dd_vjp_plain(X, Y, ii, jj, sigma, ct):
    """Plain version: :func:`vjp_pairs_plain` over chunks of pairs, then
    ``index_add_`` onto ``X`` and ``Y``."""
    COUNTS["plain"] += 1
    sig = _sigma(sigma, X)
    M, N = X.shape[1], Y.shape[1]
    chunk = max(1, _PLAIN_CHUNK_BYTES // (6 * M * N * X.element_size()))
    es = X.new_zeros(())
    dX, dY = torch.zeros_like(X), torch.zeros_like(Y)
    for s in range(0, ii.shape[0], chunk):
        ic, jc = ii[s:s + chunk], jj[s:s + chunk]
        e, dx, dy = vjp_pairs_plain(X[ic], Y[jc], sig, ct[s:s + chunk])
        es = es + e
        dX.index_add_(0, ic, dx)
        dY.index_add_(0, jc, dy)
    return es / (sig * sig), dX, dY


def _halving(v):
    """The halving tree over the last axis (32 lanes): ``v[:16] + v[16:]``,
    then ``[:8] + [8:]``, ... (the kernel's shuffles pair lanes l and
    l ^ 16 first)."""
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def _serial(v, dim):
    """The sum over ``dim`` from 0, one term after the other."""
    out = torch.zeros_like(v.select(dim, 0))
    for i in range(v.shape[dim]):
        out = out + v.select(dim, i)
    return out


def _tiled_pairs(x, y, sig, ct, H, west_halo, north_halo):
    """The kernel's arithmetic for the pairs ``(x[p], y[p])``: ``(E * D a
    pair (P,), dx (P, M, D), dy (P, N, D))``.

    Column ``n`` is lane ``n % 32`` of warp ``(n // span) % WARPS``, its
    ``k = (n // 32) % kC``-th column in chunk ``n // (span WARPS)``: a warp's
    span of ``span = 32 kC`` columns, the spans in the kernel's order of
    (chunk, warp). The cells are padded to ``bands x H`` rows and whole
    spans with ct and the points 0 there; a padded cell's W and E * D are
    then +-0, which leaves every sum unchanged, bits included (each starts
    at +0), as do the kernel's warps past the last column. ``west_halo=False``
    reads a warp's west halo as 0 (its first column's west and north-west
    ct), ``north_halo=False`` a band's north halo (the row above its first
    row): negative controls."""
    P, M, D = x.shape
    N = y.shape[1]
    kC = lane_columns(D)
    span = 32 * kC
    nb, ns = -(-M // H), -(-N // span)
    Mp, Np = nb * H, ns * span
    c = x.new_zeros(P, Mp + 1, Np + 1)  # ct at [a + 1, b + 1], 0 elsewhere
    c[:, 1:M, 1:N] = ct
    here, west = c[:, 1:, 1:], c[:, 1:, :-1].clone()
    north, nw = c[:, :-1, 1:].clone(), c[:, :-1, :-1].clone()
    if not west_halo:
        west[:, :, span::span] = 0
        nw[:, :, span::span] = 0
    if not north_halo:
        north[:, H::H] = 0
        nw[:, H::H] = 0
    dG = ((here + nw) - west) - north
    xp = x.new_zeros(P, Mp, D)
    xp[:, :M] = x
    yp = y.new_zeros(P, Np, D)
    yp[:, :N] = y
    dist = cuda_gen.sqdist(xp, yp)
    E = dG * torch.exp(-dist / sig)
    W = E * (-1.0 / sig)
    ED = E * dist
    del dG, E, dist, c, here, west, north, nw
    # columns: each band's sums serial in its rows, then the bands in order
    Wb, xb = W.view(P, nb, H, Np), xp.view(P, nb, H, D)
    cs = W.new_zeros(P, nb, Np)
    cx = W.new_zeros(P, nb, Np, D)
    for r in range(H):
        cs = cs + Wb[:, :, r]
        cx = cx + Wb[:, :, r, :, None] * xb[:, :, r, None, :]
    cs, cx = _serial(cs, 1), _serial(cx, 1)
    dy = 2.0 * (cs[..., None] * yp - cx)
    # rows: a lane's kC columns serially (rowsum, then W y), the halving
    # tree over the warp's lanes, then the spans in order
    Wr = W.view(P, Mp, ns, kC, 32)
    yr = yp.view(P, 1, ns, kC, 32, D)
    v = W.new_zeros(P, Mp, ns, 32, D + 1)
    for k in range(kC):
        w = Wr[:, :, :, k]
        v[..., 0] = v[..., 0] + w
        v[..., 1:] = v[..., 1:] + w[..., None] * yr[:, :, :, k]
    acc = _serial(_halving(v.movedim(-2, -1)), 2)
    dx = 2.0 * (acc[..., :1] * xp - acc[..., 1:])
    # E * D: a lane's cells (chunks, then rows, then its kC columns), the
    # halving tree over the warp, the warps in order, the bands in order
    EDl = ED.view(P, nb, H, ns, kC, 32)
    e = ED.new_zeros(P, nb, WARPS, 32)
    for j in range(0, ns, WARPS):
        w = min(WARPS, ns - j)
        for r in range(H):
            for k in range(kC):
                e[:, :, :w] = e[:, :, :w] + EDl[:, :, r, j:j + w, k]
    es = _serial(_serial(_halving(e), 2), 1)
    return es, dx[:, :M], dy[:, :N]


def rbf_dd_vjp_pairs_tiled_plain(X, Y, ii, jj, sigma, ct, *, band=None,
                                 west_halo=True, north_halo=True):
    """The kernel's tiling and order of sums, in plain PyTorch: ``(d sigma,
    dx (P, M, D), dy (P, N, D))`` of the pairs ``(X[ii[p]], Y[jj[p]])``
    before their scatter; equal bit for bit to :func:`rbf_dd_vjp_pairs` on
    the card. ``band``: the band's rows (default :func:`band_rows`);
    ``west_halo`` / ``north_halo``: see :func:`_tiled_pairs`."""
    COUNTS["plain"] += 1
    sig = _sigma(sigma, X)
    P, M, N, D = ii.shape[0], X.shape[1], Y.shape[1], X.shape[2]
    H = band or band_rows(D, X.element_size())
    dx = X.new_zeros(P, M, D)
    dy = X.new_zeros(P, N, D)
    es = X.new_zeros(P)
    if P and M > 1 and N > 1:
        span = 32 * lane_columns(D)
        cells = -(-M // H) * H * -(-N // span) * span
        chunk = max(1, _PLAIN_CHUNK_BYTES // ((D + 8) * cells
                                              * X.element_size()))
        for s in range(0, P, chunk):
            sl = slice(s, s + chunk)
            es[sl], dx[sl], dy[sl] = _tiled_pairs(
                X[ii[sl]], Y[jj[sl]], sig, ct[sl], H, west_halo, north_halo)
    # the pairs: lane p % 32 adds its pairs in order, then the halving tree
    lanes = es.new_zeros(-(-P // 32) * 32 or 32)
    lanes[:P] = es
    return _halving(_serial(lanes.view(-1, 32), 0)) / (sig * sig), dx, dy


def rbf_dd_vjp_tiled_plain(X, Y, ii, jj, sigma, ct, **controls):
    """:func:`rbf_dd_vjp_pairs_tiled_plain` scattered onto ``X`` and ``Y``:
    ``(d sigma, dX, dY)`` as :func:`rbf_dd_vjp` gives them."""
    ds, dx, dy = rbf_dd_vjp_pairs_tiled_plain(X, Y, ii, jj, sigma, ct,
                                              **controls)
    return (ds, torch.zeros_like(X).index_add_(0, ii, dx),
            torch.zeros_like(Y).index_add_(0, jj, dy))


def _scratch(X, P, M, N, D):
    """The launch's outputs and scratch: ``dx (P, M, D)``, ``dy (P, N, D)``,
    ``d sigma (1,)``, the column partials ``(pairs a launch, bands, D + 1,
    N)`` and the bands' and pairs' E * D ``(P, bands + 1)``; and ``(H,
    pairs a launch)``."""
    H, nb, chunk = partials(P, M, N, D, X.element_size())
    new = lambda *shape: torch.empty(*shape, dtype=X.dtype,  # noqa: E731
                                     device=X.device)
    return (new(P, M, D), new(P, N, D), new(1), new(chunk, nb, D + 1, N),
            new(P, nb + 1)), (H, chunk)


def rbf_dd_vjp_pairs(X, Y, ii, jj, sigma, ct, *, in_range=False):
    """``(d sigma, dx (P, M, D), dy (P, N, D))`` of ``sum(ct * dd(exp(-|x -
    y|^2 / sigma)))`` over the pairs ``(X[ii[p]], Y[jj[p]])``, a pair's
    path gradients before their scatter: the kernel for CUDA tensors (one
    launch a call, however many pairs; ``sigma`` by value,
    :func:`.cuda_gen.sigma_value`), its plain emulation
    (:func:`rbf_dd_vjp_pairs_tiled_plain`) for CPU tensors. ``in_range``:
    the caller built ``ii`` and ``jj`` from the batch sizes, so their bounds
    are not read (:func:`.cuda_gen.check_pairs`)."""
    if X.device.type == "cpu":
        return rbf_dd_vjp_pairs_tiled_plain(X, Y, ii, jj, sigma, ct)
    ii, jj = cuda_gen.check_pairs(X, Y, ii, jj, "rbf_dd_vjp",
                                  in_range=in_range)
    P, M, N, D = ii.shape[0], X.shape[1], Y.shape[1], X.shape[2]
    if (ct.shape != (P, max(M - 1, 0), max(N - 1, 0)) or ct.dtype != X.dtype
            or ct.device != X.device or not ct.is_contiguous()):
        raise ValueError(f"rbf_dd_vjp: ct must be a contiguous "
                         f"{(P, M - 1, N - 1)} tensor of the paths' dtype "
                         "and device")
    if P == 0 or M < 2 or N < 2:
        # no pairs, or no increments: every gradient is 0
        return (X.new_zeros(()), X.new_zeros(P, M, D), X.new_zeros(P, N, D))
    (dx, dy, ds, part, es), (H, chunk) = _scratch(X, P, M, N, D)
    _build.launch("rbf_dd_vjp", _FNS, COUNTS, X, X.data_ptr(), Y.data_ptr(),
                  ii.data_ptr(), jj.data_ptr(), ct.data_ptr(), dx.data_ptr(),
                  dy.data_ptr(), part.data_ptr(), es.data_ptr(),
                  ds.data_ptr(), P, M, N, D, cuda_gen.sigma_value(sigma), H,
                  chunk)
    return ds[0], dx, dy


@spanned("sk.op.rbf_dd_vjp")
def rbf_dd_vjp(X, Y, ii, jj, sigma, ct, *, in_range=False):
    """``(d sigma, dX, dY)`` of ``sum(ct * dd(exp(-|x - y|^2 / sigma)))``
    over the pairs ``(X[ii[p]], Y[jj[p]])``; ``ct``: ``(P, M-1, N-1)`` in
    the dtype of the paths. ``d sigma`` is a 0-d tensor of that dtype. Any
    path dimension. ``in_range`` as :func:`rbf_dd_vjp_pairs`'."""
    if X.device.type == "cpu":
        return rbf_dd_vjp_plain(X, Y, ii, jj, sigma, ct)
    ds, dx, dy = rbf_dd_vjp_pairs(X, Y, ii, jj, sigma, ct, in_range=in_range)
    return (ds, torch.zeros_like(X).index_add_(0, ii, dx),
            torch.zeros_like(Y).index_add_(0, jj, dy))
