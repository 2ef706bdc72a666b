"""The host side of the band-pipelined wavefront (``csrc/band_sweep.cuh``):
its constants, the one rule that splits a band launch, the one launch loop,
and the plain emulators of the decomposition.

Eleven kernels run on it: K1, K1-stack and K3<gen> (``cuda_gen``), K2,
K2-stack, K2-sparse and K8 (``cuda_solver``), K7, K7-stack and K3<inc,
boundary> (``cuda_blocked``) and K5 (``cuda_deriv``). Each runs one block a
(pair, band of :data:`BAND_ROWS` of the rows it sweeps). A band hands its
bottom row to the band below through a global scratch of ``(pairs, nbands
- 1, C + 1)`` columns of ``values`` numbers each (three for K5), published
in chunks of :data:`CHUNK` columns by a progress counter a block; a ticket
counter orders the blocks. The counters are zeroed before every launch.
:func:`launch` allocates the scratch and the counters once, for the largest
launch, and launches the pairs in launches of :func:`pairs_a_launch` pairs:
at most :data:`SCRATCH_BYTES` of scratch and :data:`TICKETS` blocks each.
Pairs are independent, so a split changes no value.

``BAND_FILL`` counts how full the bands are: each launch adds its pairs
times the rows it sweeps to ``"rows"`` and its pairs times its bands' rows
to ``"slots"``; a short frame leaves most of its last band's lanes idle. No
name here ends in ``COUNTS``: the launch tables are the wrappers'.

The emulators (:func:`increments`, :func:`sweep`, :func:`banded_sweep`,
:func:`banded_adjoint`) run the kernels' decomposition and arithmetic in
plain PyTorch on any device. No route runs them; the tests hold each band
kernel's emulation to its plain version bit for bit.
"""
from __future__ import annotations

import torch

from . import _build, scan_solver

# rows a block (a band) and columns a hand-off chunk (kBandRows, kChunk)
BAND_ROWS = 128
CHUNK = 32
# lanes a warp: the adjoint modes keep a base row's f refined rows in one
# warp, and K8's halo of W - 2 rows one lane a row
WARP = 32
# the hand-off scratch of one launch, with its counters. 512 MiB holds
# ~2,185 pairs at length 1024, dyadic 1 in double (16 bands, C = 2,046:
# ~35,000 blocks, some 30 waves of the card), so a launch of more pairs
# would fill the card no better; it bounds what a band kernel adds to the
# peak.
SCRATCH_BYTES = 512 << 20
# the most blocks one launch may hold (the ticket counter is a 32-bit int)
TICKETS = (1 << 31) - 1

BAND_FILL = {"rows": 0, "slots": 0}


def frame(Mb: int, Nb: int, dyadic_order: int):
    """``(R, C)``: the refined rows (the shorter side) and columns of the
    solve's frame."""
    f = 2 ** dyadic_order
    return min(Mb, Nb) * f, max(Mb, Nb) * f


def bands(R: int) -> int:
    """Bands of :data:`BAND_ROWS` rows that sweep ``R`` rows."""
    return -(-R // BAND_ROWS)


def adjoint_kernel(dyadic_order: int) -> str:
    """The adjoint kernels' choice at a refinement (K3<gen>, K3<inc,
    boundary>, and K8's first condition): ``"band"`` (the band kernel,
    whose collapse holds a base row's ``f`` refined rows in one warp) while
    ``f <= 32``, else ``"one_block"``."""
    return "band" if 2 ** dyadic_order <= WARP else "one_block"


def scratch_bytes(R: int, C: int, itemsize: int, values: int = 1) -> int:
    """Bytes of one pair's band scratch: its hand-off rows (``bands(R) -
    1`` rows of ``C + 1`` columns of ``values`` numbers of ``itemsize``
    bytes) and its progress counters (an int a band)."""
    nb = bands(R)
    return (nb - 1) * (C + 1) * values * itemsize + 4 * nb


def pairs_a_launch(P: int, R: int, C: int, itemsize: int,
                   values: int = 1) -> int:
    """Pairs of one launch: as many as keep the scratch and counters
    (:func:`scratch_bytes`, and the ticket) within :data:`SCRATCH_BYTES`,
    all ``P`` while one band holds the ``R`` rows (no hand-off rows), and
    at most :data:`TICKETS` blocks; at least one."""
    nb = bands(R)
    n = P if nb <= 1 else (SCRATCH_BYTES - 4) // scratch_bytes(
        R, C, itemsize, values)
    return max(1, min(P, n, TICKETS // nb))


def per_pair(t):
    """``(address, bytes a pair)`` of a tensor whose dim 0 runs over the
    pairs, for :func:`launch`; ``(None, 0)`` for None (a null pointer)."""
    if t is None:
        return None, 0
    return t.data_ptr(), t.stride(0) * t.element_size()


def launch(what, fns, counts, like, P, R, C, ptrs, tail, values=1) -> None:
    """Launch the band kernel ``fns[like.dtype]`` over ``P`` pairs (at
    least one) whose sweeps have ``R`` rows and ``C`` columns, on ``like``'s
    card and current stream, in launches of :func:`pairs_a_launch` pairs.
    A kernel's arguments are its tensors, the scratch, the counters, the
    launch's pair count and ``tail``, the scalars after it in the kernel's
    C signature (``nbands`` among them). ``ptrs``: ``(address, bytes a
    pair)`` of each tensor (:func:`per_pair`; 0 bytes for one that all
    pairs share, an address of None stays a null pointer), each launch's
    a pair further on. The scratch (``values`` numbers a column) and the
    counters are allocated once, for the largest launch, and the counters
    zeroed before each. Each launch is counted in ``counts`` by
    :func:`._build.launch` and in :data:`BAND_FILL`."""
    nb = bands(R)
    n = pairs_a_launch(P, R, C, like.element_size(), values)
    scratch = torch.empty(n * (nb - 1) * (C + 1) * values, dtype=like.dtype,
                          device=like.device)
    counters = torch.empty(n * nb + 1, dtype=torch.int32, device=like.device)
    for s in range(0, P, n):
        m = min(n, P - s)
        counters.zero_()
        at = [None if a is None else a + per * s for a, per in ptrs]
        _build.launch(what, fns, counts, like, *at, scratch.data_ptr(),
                      counters.data_ptr(), m, *tail)
        BAND_FILL["rows"] += m * R
        BAND_FILL["slots"] += m * nb * BAND_ROWS


# ---- the decomposition in plain PyTorch, for the tests --------------------


def increments(inc, f, row0, rows, flip):
    """The refined increments ``(P, rows, C)`` of a stripe of a pair's base
    grid by the kernels' own index arithmetic (``band_stripe``'s ``base``):
    row ``i`` reads frame row ``row0 + (rows - i if flip else i - 1)`` (zero
    at and past R), column ``c`` base column ``q = (c - 1) // f``, reversed
    with ``flip``, through the transpose when ``Mb > Nb``; scaled by the
    exact ``1 / f^2``. A whole frame is the stripe ``row0 = 0``, ``rows =
    R``."""
    P, Mb, Nb = inc.shape
    transpose = Mb > Nb
    R, C = min(Mb, Nb) * f, max(Mb, Nb) * f
    dev = inc.device
    i = torch.arange(1, rows + 1, device=dev)
    r = (rows - i if flip else i - 1) + row0
    has = r < R
    ra = torch.where(has, r // f, 0)[:, None]
    q = (torch.arange(1, C + 1, device=dev) - 1) // f
    cb = (C // f - 1 - q if flip else q)[None, :]
    at = cb * Nb + ra if transpose else ra * Nb + cb
    u = inc.reshape(P, Mb * Nb)[:, at] * (1.0 / (f * f))
    return torch.where(has[:, None], u, torch.zeros_like(u))


def _sweep_tile(north, west, u, scheme):
    """One band's chunk: the ``(P, h + 1, w + 1)`` tile whose row 0 is
    ``north`` (columns ``c0 - 1 .. c0 + w - 1``, the corner first) and whose
    column 0 below it is ``west``, swept by anti-diagonals in the plain
    sweep's operand order."""
    P, h, w = u.shape
    tile = u.new_empty(P, h + 1, w + 1)
    tile[:, 0, :] = north
    tile[:, 1:, 0] = west
    for p in range(2, h + w + 1):
        i = torch.arange(max(1, p - w), min(h, p - 1) + 1, device=u.device)
        tile[:, i, p - i] = scheme(tile[:, i - 1, p - i - 1],
                                   tile[:, i - 1, p - i],
                                   tile[:, i, p - i - 1], u[:, i - 1, p - i - 1])
    return tile


def sweep(u, bd, naive, H, Wc, visit=None, handoff=None):
    """The band decomposition: the refined increments ``u (P, rows, C)``
    swept in bands of ``H`` rows, one after another, each in chunks of
    ``Wc`` columns, a chunk taking its north row from the band above's
    hand-off row (``bd`` for band 0) and its west column from the chunk
    before. Calls ``visit(i0, c0, tile)`` on each chunk's tile (its cell
    ``(r, q)`` is the stripe's ``(i0 - 1 + r, c0 - 1 + q)``) and returns the
    bottom row ``(P, C + 1)``. ``handoff`` (a negative control of the
    tests) maps each hand-off row between two bands."""
    P, rows, C = u.shape
    scheme = scan_solver.get_scheme(naive)
    above = bd
    for i0 in range(1, rows + 1, H):  # band by band
        h = min(H, rows - i0 + 1)
        below = u.new_ones(P, C + 1)  # the band's hand-off row
        west = u.new_ones(P, h)
        for c0 in range(1, C + 1, Wc):  # chunk by chunk
            w = min(Wc, C - c0 + 1)
            tile = _sweep_tile(above[:, c0 - 1:c0 + w], west,
                               u[:, i0 - 1:i0 - 1 + h, c0 - 1:c0 - 1 + w],
                               scheme)
            west = tile[:, 1:, -1]
            below[:, c0:c0 + w] = tile[:, -1, 1:]
            if visit is not None:
                visit(i0, c0, tile)
        above = below if handoff is None or i0 + h > rows else handoff(below)
    return above


def tile_cells(i0, c0, tile):
    """The stripe's rows ``(h, 1)`` and columns ``(1, w)`` of a tile's swept
    cells."""
    h, w = tile.shape[-2] - 1, tile.shape[-1] - 1
    dev = tile.device
    return (torch.arange(i0, i0 + h, device=dev)[:, None],
            torch.arange(c0, c0 + w, device=dev)[None, :])


def banded_sweep(u, bd, naive=False, H=BAND_ROWS, Wc=CHUNK, stack=False,
                 handoff=None):
    """:func:`sweep` of the refined increments ``u (P, rows, C)`` from the
    north boundary ``bd``: the bottom row ``(P, C + 1)``, with ``stack``
    also the stack ``(P, rows + C + 1, rows + 1)`` (row 0 = ``bd``) written
    as the band kernel writes it; ``handoff``: :func:`sweep`'s."""
    P, rows, C = u.shape
    stk = visit = None
    if stack:
        stk = u.new_zeros(P, rows + C + 1, rows + 1)
        stk[:, :C + 1, 0] = bd
        diag = torch.arange(1, rows + 1, device=u.device)
        stk[:, diag, diag] = 1

        def visit(i0, c0, tile):
            i, c = tile_cells(i0, c0, tile)
            stk[:, i + c, i.expand(i.shape[0], c.shape[1])] = tile[:, 1:, 1:]
    bottom = sweep(u, bd, naive, H, Wc, visit, handoff)
    return (bottom, stk) if stack else bottom


def banded_adjoint(u, stack, bd, out, row0, R, f, naive=False, H=BAND_ROWS,
                   Wc=CHUNK, fold=None) -> None:
    """The band kernel's adjoint mode (kBandAdjoint): its arithmetic on the
    reverse problem's refined increments ``u (P, rows, C)`` as its lanes
    meet them, whatever their source. The reverse stripe is swept from
    ``bd`` as :func:`sweep` sweeps it; reverse cell ``(i, c)`` (both from 1)
    multiplies the forward stack entry the kernel reads, ``stack[rows + C -
    i - c][rows - i]``, by its north-west value. The collapse then runs the
    kernel's lane arithmetic, warp by warp (:data:`WARP` rows): lane ``t``
    holds column ``s - t`` at step ``s``; a group of ``f`` lanes (one base
    row) adds its terms, lane descending, into two open base cells ``hi``
    and ``lo``; when a new base column enters (``(C - s) % f == f - 1``) the
    cell in ``hi`` is added into ``out`` and the two shift; after the last
    step both are added. ``out``: the cotangent in the solve's frame (a
    view, updated in place), whose base rows from ``row0 / f`` the stripe
    covers; base rows at or past the frame's ``R / f`` write nothing.
    ``fold = (scale, g)`` (K3<gen>'s RbfFoldSource): each closed cell is
    stored, not added, as ``(0 + sum) * scale * g[p]`` (``g`` None: times
    1)."""
    if f > WARP:
        raise ValueError(f"the band kernel's collapse holds a base row in one "
                         f"warp of {WARP} lanes; f = {f}")
    P, rows, C = u.shape
    dyadic_order = f.bit_length() - 1
    nwarps = -(-rows // WARP)
    terms = u.new_zeros(P, nwarps * WARP, C)  # reverse row i - 1, column c - 1

    def visit(i0, c0, tile):
        i, c = tile_cells(i0, c0, tile)
        fwd = stack[:, rows + C - i - c, (rows - i).expand(i.shape[0],
                                                           c.shape[1])]
        terms[:, i - 1, c - 1] = fwd * tile[:, :-1, :-1]

    sweep(u, bd, naive, H, Wc, visit)
    dev = u.device
    groups = WARP // f
    terms = terms.reshape(P, nwarps, groups, f, C)
    gbase = torch.arange(0, WARP, f, device=dev)  # each group's first lane
    i0 = torch.arange(nwarps, device=dev)[:, None] * WARP + 1
    # the group's frame base row; base rows past the frame write nothing
    ga = row0 // f + ((rows - i0 + 1) >> dyadic_order) - gbase // f - 1
    lead = (ga >= row0 // f) & (ga < R // f)
    hi = u.new_zeros(P, nwarps, groups)
    lo = torch.zeros_like(hi)

    def emit(acc, b):
        ok = lead & ((b >= 0) & (b < C // f))[None, :]
        w, g = ok.nonzero(as_tuple=True)
        at = (slice(None), ga[w, g], b[g])
        if fold is None:
            out[at] = out[at] + acc[:, w, g]
            return
        scale, wt = fold
        v = (torch.zeros_like(acc[:, w, g]) + acc[:, w, g]) * scale
        out[at] = v * (1.0 if wt is None else wt[:, None])

    for s in range(1, C + WARP):
        rr = (C - s) & (f - 1)
        if rr == f - 1:  # a new base column enters
            emit(hi, ((C - s + gbase) >> dyadic_order) + 2)
            hi, lo = lo, torch.zeros_like(lo)
        for jj in range(f - 1, -1, -1):
            cs = s - gbase - jj
            ok = (cs >= 1) & (cs <= C)
            t = terms[:, :, torch.arange(groups, device=dev), jj,
                      (cs - 1).clamp(0, C - 1)]
            if jj >= f - rr:
                hi = torch.where(ok, hi + t, hi)
            else:
                lo = torch.where(ok, lo + t, lo)
    b0 = gbase - (WARP - 1)  # C - s + gbase after the last step
    emit(hi, (b0 >> dyadic_order) + 1)
    emit(lo, b0 >> dyadic_order)
