"""K7: grids too tall for one block, in stripes (``csrc/stripe_wavefront.cu``,
the band-pipelined wavefront of ``csrc/band_sweep.cuh``), and the striped
adjoint on K7-stack and K3<inc, boundary> (``csrc/adjoint_collapse.cu``).

Counterpart of :mod:`sigkernel_tpu.ops.pallas_blocked`. The one-block
wavefront kernels keep a ring of three diagonals of the shorter refined side
R in one block's shared memory, so R is bounded (:func:`._build.max_rows`:
9,684 rows in double, 19,369 in float). Past it the frame's rows are cut
into stripes of at most that many rows, a multiple of ``f`` so no base row
straddles two stripes. Each stripe is K2's recurrence whose row 0 is the
bottom row of the stripe above (the north boundary) instead of 1; the first
stripe's boundary is the global 1s, and the last stripe's bottom-right value
is the corner. Stripes run one launch after another on the current stream
(the data dependence is real). Inside a stripe K7 runs one block per band of
:data:`BAND_ROWS` rows of each pair, the bands handing their bottom rows on
in chunks of :data:`CHUNK` columns through a global scratch row with a
progress counter each (:func:`stripe_solve_banded_plain` emulates that
decomposition on any device, for the tests).

- :func:`solve_final` (forward): ``ceil(R / Rs)`` K7 launches, the last
  stripe short (JAX ``pallas_blocked.solve_final``/``solve_final_df``).
- :func:`adjoint` (backward, JAX ``adjoint_blocked``/``adjoint_blocked_df``):
  the frame's rows are taken as zero-padded to ``S`` stripes of
  :data:`ADJ_ROWS` (zero increments copy rows exactly, and the reverse
  problem starts with the padding, where it stays exactly 1; the kernels
  read the padding as zeros, nothing is copied). ``S - 1`` K7 launches give
  the forward's stripe boundaries and ``S - 1`` more, on the increments
  flipped in-kernel, the reverse problem's; then per stripe ``s`` (with
  ``t = S - 1 - s``) K7-stack on forward stripe ``s`` and K3<inc, boundary>,
  the reverse sweep of stripe ``t`` from its boundary multiplied in flight
  by stripe ``s``'s stack and collapsed to base rows.

K3<inc, boundary> has two kernels, chosen by shape
(:func:`stripe_adjoint_kernel`). While a base row's ``f`` refined rows fit
one warp (``f <= 32``, dyadic order at most 5) it is the band-pipelined
wavefront too, the collapse summed in registers in
``collapse_refined``'s order (:func:`stripe_adjoint_banded_plain` emulates
it). Past that a base row spans warps and the collapse cannot run in flight
in that order, so the stripe goes to the one-block kernel (one block a pair,
a barrier a diagonal), whose ring of three diagonals bounds the stripe's
rows by :func:`._build.max_rows`; the routes cut no stripe taller.

The adjoint's stripe height. One stripe's stack is ``(Rs + C + 1) (Rs + 1)``
values a pair, alive for one stripe at a time; the caller's chunk of pairs
keeps it within ``routes.STACK_BYTES`` (8 GiB). At ``Rs = 2048`` and
``C = 20,000`` (length 5,001, dyadic 2) that is 22,049 x 2,049 x 8 B =
361 MB a pair in double, 23 pairs a chunk (181 MB and 47 in float). A
taller stripe costs fewer diagonals in all (``S (Rs + C)``) but a stack
that grows as ``Rs (Rs + C)``: at the row bound, 9,684, it would be 2.3 GB
a pair and 3 pairs a chunk. 2,048 is JAX's ``ADJ_ROWS``.

Each wrapper launches its kernel for CUDA tensors and takes its plain
version (``*_plain``, on :func:`.scan_solver.solve_stripe`) only for CPU
tensors. ``COUNTS`` (K7), ``STACK_COUNTS`` (K7-stack) and
``ADJOINT_COUNTS`` (K3<inc, boundary>) hold the launches per dtype and the
calls of the plain versions; ``ADJOINT_COUNTS["one_block"]`` counts the
one-block kernel's launches (``f > 32``), which the dtype keys leave out.
"""
from __future__ import annotations

import torch

from . import _build, cuda_solver, scan_solver
from ..tracing import spanned
from ..utils import dyadic_refine

COUNTS = {"float32": 0, "float64": 0, "plain": 0}
STACK_COUNTS = {"float32": 0, "float64": 0, "plain": 0}
ADJOINT_COUNTS = {"float32": 0, "float64": 0, "one_block": 0, "plain": 0}

# the striped adjoint's stripe height (refined rows), before rounding to f
ADJ_ROWS = 2048
# K7's band (rows a block) and hand-off chunk (columns), as in
# csrc/band_sweep.cuh (kBandRows, kChunk)
BAND_ROWS = 128
CHUNK = 32
# lanes a warp: K3<inc, boundary>'s band kernel keeps a base row's f refined
# rows in one warp
WARP = 32

_FNS = {torch.float32: "sk_stripe_f32", torch.float64: "sk_stripe_f64"}
_STACK_FNS = {torch.float32: "sk_stripe_stack_f32",
              torch.float64: "sk_stripe_stack_f64"}
_ADJOINT_FNS = {torch.float32: "sk_adjoint_band_f32",
                torch.float64: "sk_adjoint_band_f64"}
_ONE_BLOCK_FNS = {torch.float32: "sk_adjoint_stripe_f32",
                  torch.float64: "sk_adjoint_stripe_f64"}


def frame(Mb: int, Nb: int, dyadic_order: int):
    """``(R, C)``: the refined rows (the shorter side) and columns of the
    solve's frame."""
    f = 2 ** dyadic_order
    return min(Mb, Nb) * f, max(Mb, Nb) * f


def stripe_rows(dyadic_order: int, itemsize: int, cap=None) -> int:
    """The stripe height: the largest multiple of ``f`` within the row
    bound (and within ``cap``)."""
    f = 2 ** dyadic_order
    rows = _build.max_rows(itemsize)
    if cap is not None:
        rows = min(rows, cap)
    if rows < f:
        raise ValueError(f"a stripe must hold one base row ({f} refined "
                         f"rows); the bound allows {rows}")
    return rows // f * f


def stripe_increments(inc: torch.Tensor, dyadic_order: int, row0: int,
                      rows: int, flip: bool = False) -> torch.Tensor:
    """The refined increments ``(P, rows, C)`` of one stripe in the solve's
    frame, zero past the frame's rows, reversed along both axes with
    ``flip``: what K7 reads through ``StripeGrid``. Only the stripe's base
    rows are refined."""
    f = 2 ** dyadic_order
    base = inc.transpose(-1, -2) if inc.shape[-2] > inc.shape[-1] else inc
    s = dyadic_refine(base[..., row0 // f:(row0 + rows) // f, :], dyadic_order)
    if s.shape[-2] < rows:
        s = torch.cat([s, s.new_zeros(*s.shape[:-2], rows - s.shape[-2],
                                      s.shape[-1])], dim=-2)
    return scan_solver.flip2(s) if flip else s


def stripe_solve_plain(inc, bd, row0, rows, dyadic_order=0, naive=False,
                       flip=False) -> torch.Tensor:
    """Plain version of K7: the stripe's bottom row by
    :func:`.scan_solver.solve_stripe`."""
    COUNTS["plain"] += 1
    return scan_solver.solve_stripe(
        stripe_increments(inc, dyadic_order, row0, rows, flip), bd, naive)


def stripe_solve_stack_plain(inc, bd, row0, rows, dyadic_order=0,
                             naive=False, flip=False):
    """Plain version of K7-stack: ``(bottom row, stack)`` from
    :func:`.scan_solver.solve_stripe_grid`, laid out as the stack (row 0 =
    ``bd``)."""
    STACK_COUNTS["plain"] += 1
    grid = scan_solver.solve_stripe_grid(
        stripe_increments(inc, dyadic_order, row0, rows, flip), bd, naive)
    return grid[..., -1, :].clone(), scan_solver.grid_to_stack(grid)


def _band_increments(inc, f, row0, rows, flip):
    """The stripe's refined increments ``(P, rows, C)`` by K7's own index
    arithmetic (``band_stripe``'s ``base``): row ``i`` reads frame row
    ``row0 + (rows - i if flip else i - 1)`` (zero at and past R), column
    ``c`` base column ``q = (c - 1) // f``, reversed with ``flip``, through
    the transpose when ``Mb > Nb``; scaled by the exact ``1 / f^2``."""
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


def _band_sweep(u, bd, naive, H, Wc, visit=None, handoff=None):
    """The band decomposition in plain PyTorch: the refined increments ``u
    (P, rows, C)`` swept in bands of ``H`` rows, one after another, each in
    chunks of ``Wc`` columns, a chunk taking its north row from the band
    above's hand-off row (``bd`` for band 0) and its west column from the
    chunk before. Calls ``visit(i0, c0, tile)`` on each chunk's tile (its
    cell ``(r, q)`` is the stripe's ``(i0 - 1 + r, c0 - 1 + q)``) and
    returns the bottom row ``(P, C + 1)``. ``handoff`` (a negative control
    of the tests) maps each hand-off row between two bands."""
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


def _tile_cells(i0, c0, tile):
    """The stripe's rows ``(h, 1)`` and columns ``(1, w)`` of a tile's swept
    cells."""
    h, w = tile.shape[-2] - 1, tile.shape[-1] - 1
    dev = tile.device
    return (torch.arange(i0, i0 + h, device=dev)[:, None],
            torch.arange(c0, c0 + w, device=dev)[None, :])


def stripe_solve_banded_plain(inc, bd, row0, rows, dyadic_order=0,
                              naive=False, flip=False, H=BAND_ROWS, Wc=CHUNK,
                              stack=False):
    """K7's decomposition (:func:`_band_sweep`) in plain PyTorch, for the
    tests. Returns the bottom row ``(P, C + 1)``, with ``stack`` also
    K7-stack's stack written as the kernel writes it. Bit for bit
    :func:`stripe_solve_plain` / :func:`stripe_solve_stack_plain`; no route
    runs it."""
    u = _band_increments(inc, 2 ** dyadic_order, row0, rows, flip)
    return banded_sweep(u, bd, naive, H, Wc, stack)


def banded_sweep(u, bd, naive=False, H=BAND_ROWS, Wc=CHUNK, stack=False,
                 handoff=None):
    """:func:`_band_sweep` of the refined increments ``u (P, rows, C)`` from
    the north boundary ``bd``: the bottom row ``(P, C + 1)``, with ``stack``
    also the stack ``(P, rows + C + 1, rows + 1)`` (row 0 = ``bd``) written
    as the band kernel writes it; ``handoff``: :func:`_band_sweep`'s."""
    P, rows, C = u.shape
    stk = visit = None
    if stack:
        stk = u.new_zeros(P, rows + C + 1, rows + 1)
        stk[:, :C + 1, 0] = bd
        diag = torch.arange(1, rows + 1, device=u.device)
        stk[:, diag, diag] = 1

        def visit(i0, c0, tile):
            i, c = _tile_cells(i0, c0, tile)
            stk[:, i + c, i.expand(i.shape[0], c.shape[1])] = tile[:, 1:, 1:]
    bottom = _band_sweep(u, bd, naive, H, Wc, visit, handoff)
    return (bottom, stk) if stack else bottom


def banded_adjoint(u, stack, bd, out, row0, R, f, naive=False, H=BAND_ROWS,
                   Wc=CHUNK) -> None:
    """The band kernel's adjoint mode (kBandAdjoint) in plain PyTorch, for
    the tests: its arithmetic on the reverse problem's refined increments
    ``u (P, rows, C)`` as its lanes meet them, whatever their source. The
    reverse stripe is swept from ``bd`` as :func:`_band_sweep` sweeps it;
    reverse cell ``(i, c)`` (both from 1) multiplies the forward stack
    entry the kernel reads, ``stack[rows + C - i - c][rows - i]``, by its
    north-west value. The collapse then runs the kernel's lane arithmetic,
    warp by warp (:data:`WARP` rows): lane ``t`` holds column ``s - t`` at
    step ``s``; a group of ``f`` lanes (one base row) adds its terms, lane
    descending, into two open base cells ``hi`` and ``lo``; when a new base
    column enters (``(C - s) % f == f - 1``) the cell in ``hi`` is added
    into ``out`` and the two shift; after the last step both are added.
    ``out``: the cotangent in the solve's frame (a view, updated in place),
    whose base rows from ``row0 / f`` the stripe covers; base rows at or
    past the frame's ``R / f`` write nothing."""
    if f > WARP:
        raise ValueError(f"the band kernel's collapse holds a base row in one "
                         f"warp of {WARP} lanes; f = {f}")
    P, rows, C = u.shape
    dyadic_order = f.bit_length() - 1
    nwarps = -(-rows // WARP)
    terms = u.new_zeros(P, nwarps * WARP, C)  # reverse row i - 1, column c - 1

    def visit(i0, c0, tile):
        i, c = _tile_cells(i0, c0, tile)
        fwd = stack[:, rows + C - i - c, (rows - i).expand(i.shape[0],
                                                           c.shape[1])]
        terms[:, i - 1, c - 1] = fwd * tile[:, :-1, :-1]

    _band_sweep(u, bd, naive, H, Wc, visit)
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
        out[:, ga[w, g], b[g]] = out[:, ga[w, g], b[g]] + acc[:, w, g]

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


def stripe_adjoint_banded_plain(inc, stack, bd, ct, row0, rows,
                                dyadic_order=0, naive=False, H=BAND_ROWS,
                                Wc=CHUNK) -> torch.Tensor:
    """K3<inc, boundary>'s band kernel in plain PyTorch, for the tests:
    :func:`banded_adjoint` on the stripe's reversed increments as the
    kernel reads them (:func:`_band_increments` with ``flip``), into ``ct``
    in the solve's frame. Updates ``ct`` in place and returns it. Bit for
    bit :func:`stripe_adjoint_plain`; no route runs it."""
    _, Mb, Nb = inc.shape
    f = 2 ** dyadic_order
    R, _ = frame(Mb, Nb, dyadic_order)
    out = ct.transpose(-1, -2) if Mb > Nb else ct  # the solve's frame
    banded_adjoint(_band_increments(inc, f, row0, rows, True), stack, bd,
                   out, row0, R, f, naive, H, Wc)
    return ct


def stripe_adjoint_plain(inc, stack, bd, ct, row0, rows, dyadic_order=0,
                         naive=False) -> torch.Tensor:
    """Plain version of K3<inc, boundary>: forward stripe ``s`` from its
    stack, the reverse stripe from its boundary ``bd`` by
    :func:`.scan_solver.solve_stripe_grid`, their product, the unscaled
    block sums (:func:`.scan_solver.collapse_refined`) added into ``ct``'s
    base rows of the stripe (in place; ``ct`` is returned)."""
    ADJOINT_COUNTS["plain"] += 1
    f = 2 ** dyadic_order
    C = stack.shape[-2] - rows - 1
    grid = scan_solver.stack_to_grid(stack, rows, C)
    rev = scan_solver.solve_stripe_grid(
        stripe_increments(inc, dyadic_order, row0, rows, flip=True), bd,
        naive)
    sums = scan_solver.collapse_refined(
        grid[..., :-1, :-1] * scan_solver.flip2(rev)[..., 1:, 1:], f)
    out = ct.transpose(-1, -2) if ct.shape[-2] > ct.shape[-1] else ct
    a0 = row0 // f
    n = min(rows // f, out.shape[-2] - a0)
    out[..., a0:a0 + n, :] += sums[..., :n, :]
    return ct


def stripe_adjoint_kernel(dyadic_order: int) -> str:
    """K3<inc, boundary>'s kernel at a refinement: ``"band"`` (the
    band-pipelined kernel, whose collapse holds a base row's ``f`` refined
    rows in one warp) while ``f <= 32``, else ``"one_block"``."""
    return "band" if 2 ** dyadic_order <= WARP else "one_block"


def _check(inc, bd, row0, rows, dyadic_order, what, one_block=False):
    cuda_solver._check(inc, what)
    P, Mb, Nb = inc.shape
    f = 2 ** dyadic_order
    R, C = frame(Mb, Nb, dyadic_order)
    if (bd.shape != (P, C + 1) or bd.dtype != inc.dtype
            or bd.device != inc.device or not bd.is_contiguous()):
        raise ValueError(f"{what}: the boundary must be a contiguous "
                         f"{(P, C + 1)} tensor of the grid's dtype and device")
    if rows < 1 or rows % f or row0 % f or row0 < 0 or row0 >= R:
        raise ValueError(f"{what}: stripe rows {row0} + {rows} must be "
                         f"multiples of f = {f} starting inside the frame's "
                         f"{R} rows")
    if rows > C:
        raise ValueError(f"{what}: a stripe of {rows} rows is taller than "
                         f"the frame's {C} columns")
    bound = _build.max_rows(inc.element_size())
    if one_block and rows > bound:
        raise ValueError(f"{what}: at f = {f} > {WARP} K3<inc, boundary> runs "
                         f"one block a pair, whose ring of three diagonals "
                         f"in shared memory holds at most {bound} rows; the "
                         f"stripe has {rows} (the routes cut none taller)")
    return P, Mb, Nb, f, C


def _band_scratch(inc, rows, C):
    """``(nbands, scratch, counters)`` of one band launch: the bands' hand-off
    rows ``(P, nbands - 1, C + 1)`` and the zeroed progress counters and
    ticket (``P * nbands + 1`` ints), on the current stream."""
    P = inc.shape[0]
    nbands = -(-rows // BAND_ROWS)
    scratch = torch.empty(P * (nbands - 1) * (C + 1), dtype=inc.dtype,
                          device=inc.device)
    counters = torch.zeros(P * nbands + 1, dtype=torch.int32,
                           device=inc.device)
    return nbands, scratch, counters


@spanned("sk.op.stripe_wavefront")
def stripe_solve(inc, bd, row0, rows, dyadic_order=0, naive=False,
                 flip=False) -> torch.Tensor:
    """K7: the bottom row ``(P, C + 1)`` of the stripe of refined frame rows
    ``row0 .. row0 + rows - 1`` of each pair's base grid ``inc (P, Mb, Nb)``
    swept from the north boundary ``bd (P, C + 1)``; with ``flip``, of the
    reverse problem's stripe (the stripe's increments reversed along both
    axes)."""
    if inc.device.type == "cpu":
        return stripe_solve_plain(inc, bd, row0, rows, dyadic_order, naive,
                                  flip)
    P, Mb, Nb, f, C = _check(inc, bd, row0, rows, dyadic_order,
                             "stripe_solve")
    bottom = torch.empty_like(bd)
    if P:
        nbands, scratch, counters = _band_scratch(inc, rows, C)
        _build.launch("stripe_wavefront", _FNS, COUNTS, inc, inc.data_ptr(),
                      bd.data_ptr(), bottom.data_ptr(), scratch.data_ptr(),
                      counters.data_ptr(), P, Mb, Nb, f, row0, rows, nbands,
                      int(flip), int(naive))
    return bottom


@spanned("sk.op.stripe_wavefront[stack]")
def stripe_solve_stack(inc, bd, row0, rows, dyadic_order=0, naive=False,
                       flip=False):
    """K7-stack: ``(bottom row, stack)``, the stack ``(P, rows + C + 1,
    rows + 1)`` in K2-stack's layout with row 0 = ``bd``."""
    if inc.device.type == "cpu":
        return stripe_solve_stack_plain(inc, bd, row0, rows, dyadic_order,
                                        naive, flip)
    P, Mb, Nb, f, C = _check(inc, bd, row0, rows, dyadic_order,
                             "stripe_solve_stack")
    bottom = torch.empty_like(bd)
    stack = torch.empty(cuda_solver.stack_shape(P, rows, C), dtype=inc.dtype,
                        device=inc.device)
    if P:
        nbands, scratch, counters = _band_scratch(inc, rows, C)
        _build.launch("stripe_wavefront[stack]", _STACK_FNS, STACK_COUNTS,
                      inc, inc.data_ptr(), bd.data_ptr(), bottom.data_ptr(),
                      stack.data_ptr(), scratch.data_ptr(),
                      counters.data_ptr(), P, Mb, Nb, f, row0, rows, nbands,
                      int(flip), int(naive))
    return bottom, stack


@spanned("sk.op.adjoint_collapse_stripe")
def stripe_adjoint(inc, stack, bd, ct, row0, rows, dyadic_order=0,
                   naive=False) -> torch.Tensor:
    """K3<inc, boundary>: add the unscaled block sums of forward stripe
    ``row0 .. row0 + rows - 1`` (its K7-stack ``stack``) times the reverse
    problem's matching stripe, swept from its boundary ``bd``, into ``ct``'s
    base rows of the stripe (``ct (P, Mb, Nb)``, updated in place and
    returned). The kernel by :func:`stripe_adjoint_kernel`."""
    if inc.device.type == "cpu":
        return stripe_adjoint_plain(inc, stack, bd, ct, row0, rows,
                                    dyadic_order, naive)
    one_block = stripe_adjoint_kernel(dyadic_order) == "one_block"
    P, Mb, Nb, f, C = _check(inc, bd, row0, rows, dyadic_order,
                             "stripe_adjoint", one_block)
    want = cuda_solver.stack_shape(P, rows, C)
    for name, t, shape in (("stack", stack, want), ("ct", ct, inc.shape)):
        if (t.shape != shape or t.dtype != inc.dtype
                or t.device != inc.device or not t.is_contiguous()):
            raise ValueError(f"stripe_adjoint: {name} must be a contiguous "
                             f"{tuple(shape)} tensor of the grid's dtype and "
                             "device")
    if P and one_block:
        _build.launch("adjoint_collapse_stripe[one block]", _ONE_BLOCK_FNS,
                      ADJOINT_COUNTS, inc, inc.data_ptr(), stack.data_ptr(),
                      bd.data_ptr(), ct.data_ptr(), P, Mb, Nb, f, row0, rows,
                      int(naive), key="one_block")
    elif P:
        nbands, scratch, counters = _band_scratch(inc, rows, C)
        _build.launch("adjoint_collapse_stripe", _ADJOINT_FNS, ADJOINT_COUNTS,
                      inc, inc.data_ptr(), stack.data_ptr(), bd.data_ptr(),
                      ct.data_ptr(), scratch.data_ptr(), counters.data_ptr(),
                      P, Mb, Nb, f, row0, rows, nbands, int(naive))
    return ct


def _stripes(step, inc, dyadic_order, naive, rows):
    P, Mb, Nb = inc.shape
    if P == 0 or Mb == 0 or Nb == 0:
        return inc.new_ones(P)
    R, C = frame(Mb, Nb, dyadic_order)
    Rs = min(rows or stripe_rows(dyadic_order, inc.element_size()), R)
    bd = inc.new_ones(P, C + 1)
    for row0 in range(0, R, Rs):
        bd = step(inc, bd, row0, min(Rs, R - row0), dyadic_order, naive)
    return bd[:, C].clone()


def solve_final(inc: torch.Tensor, dyadic_order: int = 0,
                naive: bool = False, rows=None) -> torch.Tensor:
    """``K[MM, NN]`` of each pair of a ``(P, Mb, Nb)`` base grid through
    stripes of ``rows`` refined rows (default: :func:`stripe_rows`), the
    last one short: one K7 launch a stripe."""
    return _stripes(stripe_solve, inc, dyadic_order, naive, rows)


def solve_final_plain(inc: torch.Tensor, dyadic_order: int = 0,
                      naive: bool = False, rows=None) -> torch.Tensor:
    """:func:`solve_final` through the plain version of K7 on any device."""
    return _stripes(stripe_solve_plain, inc, dyadic_order, naive, rows)


def adjoint_rows(dyadic_order: int, itemsize: int) -> int:
    """The striped adjoint's stripe height: :data:`ADJ_ROWS` within the
    row bound, a multiple of ``f``."""
    return stripe_rows(dyadic_order, itemsize, ADJ_ROWS)


def adjoint(inc: torch.Tensor, dyadic_order: int = 0, naive: bool = False,
            rows=None) -> torch.Tensor:
    """The striped adjoint: the gradient ``(P, Mb, Nb)`` of each pair's
    corner in its base increments (unit upstream cotangent), through
    stripes of ``rows`` refined rows (default: :func:`adjoint_rows`). One
    stripe's stack per pair is alive at a time."""
    P, Mb, Nb = inc.shape
    ct = torch.zeros_like(inc)
    if P == 0 or Mb == 0 or Nb == 0:
        return ct
    f = 2 ** dyadic_order
    R, C = frame(Mb, Nb, dyadic_order)
    Rs = min(rows or adjoint_rows(dyadic_order, inc.element_size()), R)
    S = -(-R // Rs)
    ones = inc.new_ones(P, C + 1)
    bd_f, bd_r = [ones], [ones]
    for k in range(S - 1):
        bd_f.append(stripe_solve(inc, bd_f[-1], k * Rs, Rs, dyadic_order,
                                 naive))
        bd_r.append(stripe_solve(inc, bd_r[-1], (S - 1 - k) * Rs, Rs,
                                 dyadic_order, naive, flip=True))
    for s in range(S):
        _, stack = stripe_solve_stack(inc, bd_f[s], s * Rs, Rs, dyadic_order,
                                      naive)
        stripe_adjoint(inc, stack, bd_r[S - 1 - s], ct, s * Rs, Rs,
                       dyadic_order, naive)
        del stack
    return ct / (f * f)
