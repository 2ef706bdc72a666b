"""K2: the increment-grid wavefront (``csrc/inc_wavefront.cu``), its
stack-emitting instance, and K3<inc>, the adjoint over the same grid
(``csrc/adjoint_collapse.cu``).

K2 replaces the value path of ``sigkernel_tpu/ops/pallas_solver.py``
(``_wavefront_kernel``, ``_wavefront_f32_planes_kernel``) and of
``sigkernel_tpu/ops/pallas_df64.py`` (``_wavefront_df_kernel``,
``_wavefront_df_planes_kernel``): the corner ``K[MM, NN]`` of each pair's
Goursat solve over a base increment grid ``(P, Mb, Nb)`` refined by
``2^dyadic_order`` in the kernel, in the solve's frame (transposed when
``Mb > Nb``). It is the band-pipelined wavefront of ``csrc/band_sweep.cuh``
over each pair's whole frame from 1s, with the grid as its increment
source (``IncSource``): a block per (pair, band of
:data:`.band.BAND_ROWS` rows), a lane a row, no row bound
(:func:`inc_solve_final_banded_plain` emulates it). On the H100 its bound
is reading the increment grid, which it reads at base resolution: the
refined grid never exists.

K2-stack (:func:`inc_solve_stack`) also writes the solution stack, the
grid/stack outputs of those TPU kernels, on the same band kernel
(:func:`inc_solve_stack_banded_plain`). K3<inc> (:func:`inc_adjoint`)
replaces ``pallas_adjoint.py``'s ``_product_kernel``,
``_product_collapse_kernel`` and ``_product_collapse_planes_kernel``: the
reverse sweep, its product with the stack, and the dyadic collapse, giving
the base-resolution gradient of each corner in its increments.

K2-sparse (:func:`inc_solve_sparse`) writes only the sparse stack, two of
every :data:`CKPT_WINDOW` diagonals (the ckpt output of
``pallas_df64.py``'s ``_wavefront_df_kernel``), on the band kernel's
sparse-stack mode (:func:`inc_solve_sparse_banded_plain`), and K8
(:func:`inc_adjoint_ckpt`, ``csrc/adjoint_ckpt.cu``) replaces
``pallas_adjoint.py``'s ``_product_ckpt_kernel``: K3<inc> with the skipped
forward diagonals recomputed in-kernel, window by window, bit for bit as
the forward computed them. The pair serves the backward when a chunk
would hold too few full stacks (the ckpt gate, ``routes.resolve_inc_tier``). K8 has two kernels,
chosen by shape (:func:`ckpt_kernel`): while a base row's ``f`` refined rows
fit one warp (``f <= 32``) and a window's halo of ``W - 2`` rows fits one
(``W <= 34``), the band-pipelined wavefront of ``csrc/band_sweep.cuh``
(kBandCkpt: the reverse frame swept in bands of
:data:`.band.BAND_ROWS` rows, each warp recomputing its rows'
forward values a window at a time from the sparse stack, with a halo of
``W - 2`` rows above it; :func:`inc_adjoint_ckpt_banded_plain` emulates
it); past that the one-block kernel (a block a pair, a barrier a diagonal,
within the row bound).

The band wrappers (the K2 family's and K8's) launch through
:func:`.band.launch`, which splits the pairs so that the bands' hand-off
scratch stays within :data:`.band.SCRATCH_BYTES` and a launch within
:data:`.band.TICKETS` blocks. Each wrapper launches its kernel for CUDA
tensors and takes its plain version (``*_plain``) only for CPU tensors.
``COUNTS``, ``STACK_COUNTS``, ``ADJOINT_COUNTS``, ``SPARSE_COUNTS`` and
``CKPT_COUNTS`` hold the kernel launches per dtype and the calls of the
plain versions;
``CKPT_COUNTS["one_block"]`` counts K8's one-block launches, which the
dtype keys leave out.
"""
from __future__ import annotations

import torch

from . import _build, band, scan_solver
from ..tracing import spanned
from ..utils import dyadic_refine

COUNTS = {"float32": 0, "float64": 0, "plain": 0}
STACK_COUNTS = {"float32": 0, "float64": 0, "plain": 0}
ADJOINT_COUNTS = {"float32": 0, "float64": 0, "plain": 0}
SPARSE_COUNTS = {"float32": 0, "float64": 0, "plain": 0}
CKPT_COUNTS = {"float32": 0, "float64": 0, "one_block": 0, "plain": 0}

# K8's window: diagonals between stored pairs, at least 2. The sparse stack
# is W / 2 times smaller than the full one; the band kernel's warps
# recompute W - 2 diagonals a window with a halo of W - 2 rows
# (csrc/band_sweep.cuh). Read at call time.
CKPT_WINDOW = 8

_FNS = {torch.float32: "sk_inc_wavefront_f32",
        torch.float64: "sk_inc_wavefront_f64"}
_STACK_FNS = {torch.float32: "sk_inc_stack_f32",
              torch.float64: "sk_inc_stack_f64"}
_ADJOINT_FNS = {torch.float32: "sk_adjoint_inc_f32",
                torch.float64: "sk_adjoint_inc_f64"}
_SPARSE_FNS = {torch.float32: "sk_inc_sparse_f32",
               torch.float64: "sk_inc_sparse_f64"}
_CKPT_FNS = {torch.float32: "sk_adjoint_ckpt_band_f32",
             torch.float64: "sk_adjoint_ckpt_band_f64"}
_CKPT_ONE_BLOCK_FNS = {torch.float32: "sk_adjoint_ckpt_f32",
                       torch.float64: "sk_adjoint_ckpt_f64"}


def stack_shape(P: int, MM: int, NN: int):
    """The stack of ``P`` refined ``MM x NN`` grids: ``(P, R + C + 1,
    R + 1)`` with ``R`` the shorter side (``csrc/wavefront.cuh``)."""
    R, C = min(MM, NN), max(MM, NN)
    return (P, R + C + 1, R + 1)


def window() -> int:
    """:data:`CKPT_WINDOW`, checked. Any grid with both sides at least 1
    has a sparse stack at any window of 2 or more diagonals: JAX's ``f in
    (2, 4)`` and first-window conditions (``ckpt_supported``) came from its
    residue algebra on lane windows; this layout needs neither."""
    if CKPT_WINDOW < 2:
        raise ValueError("the sparse stack's window must hold at least 2 "
                         f"diagonals; CKPT_WINDOW is {CKPT_WINDOW}")
    return CKPT_WINDOW


def sparse_shape(P: int, MM: int, NN: int):
    """The sparse stack of ``P`` refined ``MM x NN`` grids:
    ``(P, 2 ckpt_pairs, R + 1)`` (``csrc/wavefront.cuh``)."""
    R, C = min(MM, NN), max(MM, NN)
    return (P, 2 * scan_solver.ckpt_pairs(R, C, window()), R + 1)


def inc_solve_final_plain(inc: torch.Tensor, dyadic_order: int = 0,
                          naive: bool = False) -> torch.Tensor:
    """Plain version: refine the grid, then the plain anti-diagonal loop."""
    COUNTS["plain"] += 1
    return scan_solver.solve_final(dyadic_refine(inc, dyadic_order), naive)


def inc_solve_stack_plain(inc: torch.Tensor, dyadic_order: int = 0,
                          naive: bool = False):
    """Plain version of K2-stack: the plain grid, laid out as the stack."""
    STACK_COUNTS["plain"] += 1
    grid = scan_solver.solve_grid(dyadic_refine(inc, dyadic_order), naive)
    # clone: a view of the corner would keep the whole grid alive
    return grid[..., -1, -1].clone(), scan_solver.grid_to_stack(grid)


def inc_solve_final_banded_plain(inc: torch.Tensor, dyadic_order: int = 0,
                                 naive: bool = False, H=None, Wc=None,
                                 handoff=None) -> torch.Tensor:
    """K2's band kernel in plain PyTorch, for the tests: the whole frame's
    refined increments by the kernel's index arithmetic
    (:func:`.band.increments`) swept from a row 0 of 1s in bands of ``H``
    rows and chunks of ``Wc`` columns (default: the kernel's,
    :data:`.band.BAND_ROWS` and :data:`.band.CHUNK`); the corners ``(P,)``.
    Bit for bit :func:`inc_solve_final_plain`; no route runs it.
    ``handoff``: a negative control (:func:`.band.sweep`)."""
    P, Mb, Nb = inc.shape
    if P == 0 or Mb == 0 or Nb == 0:
        return inc.new_ones(P)
    u, bd = _frame_increments(inc, dyadic_order)
    return band.banded_sweep(
        u, bd, naive, H or band.BAND_ROWS, Wc or band.CHUNK,
        handoff=handoff)[:, -1].clone()


def inc_solve_stack_banded_plain(inc: torch.Tensor, dyadic_order: int = 0,
                                 naive: bool = False, H=None, Wc=None,
                                 handoff=None):
    """K2-stack's band kernel in plain PyTorch, for the tests: ``(values,
    stack)`` as :func:`inc_solve_final_banded_plain` sweeps them, the stack
    written as the kernel writes it (:func:`.band.banded_sweep`:
    row 0 the constant 1 to column C, the swept cells on their diagonals,
    1 at column 0, 0 outside). Bit for bit :func:`inc_solve_stack_plain`."""
    u, bd = _frame_increments(inc, dyadic_order)
    bottom, stack = band.banded_sweep(
        u, bd, naive, H or band.BAND_ROWS, Wc or band.CHUNK, stack=True,
        handoff=handoff)
    return bottom[:, -1].clone(), stack


def inc_solve_sparse_banded_plain(inc: torch.Tensor, dyadic_order: int = 0,
                                  naive: bool = False, H=None, Wc=None,
                                  W=None, handoff=None):
    """K2-sparse's band kernel in plain PyTorch, for the tests: ``(values,
    sparse stack)`` at window ``W`` (default :func:`window`), every entry
    written as the kernel's sparse-stack mode writes it, into a stack of
    NaN: row 0 the constant 1 to column C, then 0 (band 0's first warp);
    each row's entries left of and at column 0 (1 at it) and past column C
    (0) on the stored diagonals; and each swept cell whose diagonal ``p``
    is stored (``p % W < 2``, ``p // W < ckpt_pairs``) in sparse row ``2
    (p // W) + p % W``. Bit for bit :func:`inc_solve_sparse_plain`."""
    P, Mb, Nb = inc.shape
    W = window() if W is None else W
    R, C = band.frame(Mb, Nb, dyadic_order)
    pairs = scan_solver.ckpt_pairs(R, C, W)
    dev = inc.device
    p = torch.tensor(scan_solver.sparse_rows(R, C, W), device=dev)[:, None]
    i = torch.arange(R + 1, device=dev)[None, :]
    fixed = (i == 0) | (p <= i) | (p > i + C)
    edge = torch.where(i == 0, p <= C, p == i).to(inc.dtype)
    sparse = inc.new_full((P, 2 * pairs, R + 1), float("nan"))
    sparse[:, fixed] = edge.expand_as(fixed)[fixed]

    def visit(i0, c0, tile):
        rows, cols = band.tile_cells(i0, c0, tile)
        d = rows + cols  # each cell's diagonal
        keep = (d % W < 2) & (d // W < pairs)
        at = (2 * (d // W) + d % W)[keep]
        sparse[:, at, rows.expand_as(d)[keep]] = tile[:, 1:, 1:][:, keep]

    u, bd = _frame_increments(inc, dyadic_order)
    bottom = band.sweep(u, bd, naive, H or band.BAND_ROWS, Wc or band.CHUNK,
                        visit, handoff)
    return bottom[:, -1].clone(), sparse


def _frame_increments(inc, dyadic_order):
    """The whole frame's refined increments ``(P, R, C)`` as the band
    kernel's ``IncSource`` reads them, and its row 0, 1s ``(P, C + 1)``."""
    P, Mb, Nb = inc.shape
    R, C = band.frame(Mb, Nb, dyadic_order)
    u = band.increments(inc, 2 ** dyadic_order, 0, R, False)
    return u, inc.new_ones(P, C + 1)


def inc_adjoint_plain(inc: torch.Tensor, stack: torch.Tensor,
                      dyadic_order: int = 0,
                      naive: bool = False) -> torch.Tensor:
    """Plain version of K3<inc>: :func:`.scan_solver.adjoint_from_stack`."""
    ADJOINT_COUNTS["plain"] += 1
    return scan_solver.adjoint_from_stack(dyadic_refine(inc, dyadic_order),
                                          stack, 2 ** dyadic_order, naive)


def inc_solve_sparse_plain(inc: torch.Tensor, dyadic_order: int = 0,
                           naive: bool = False):
    """Plain version of K2-sparse: the plain grid's stack, checkpoint rows
    only (:func:`.scan_solver.stack_to_sparse`)."""
    SPARSE_COUNTS["plain"] += 1
    grid = scan_solver.solve_grid(dyadic_refine(inc, dyadic_order), naive)
    return (grid[..., -1, -1].clone(),
            scan_solver.stack_to_sparse(scan_solver.grid_to_stack(grid),
                                        window()))


def inc_adjoint_ckpt_plain(inc: torch.Tensor, sparse: torch.Tensor,
                           dyadic_order: int = 0,
                           naive: bool = False) -> torch.Tensor:
    """Plain version of K8: the full stack rebuilt window by window
    (:func:`.scan_solver.sparse_to_stack`), then the plain adjoint."""
    CKPT_COUNTS["plain"] += 1
    ref = dyadic_refine(inc, dyadic_order)
    stack = scan_solver.sparse_to_stack(sparse, ref, window(), naive)
    return scan_solver.adjoint_from_stack(ref, stack, 2 ** dyadic_order,
                                          naive)


def ckpt_warp_stack(sparse: torch.Tensor, u: torch.Tensor, W: int,
                    naive: bool = False, halo=None,
                    top_from_pair: bool = False) -> torch.Tensor:
    """The forward values K8's band kernel reads, as its warps recompute
    them (``csrc/band_sweep.cuh``, kBandCkpt), laid out as the full stack
    ``(P, R + C + 1, R + 1)``: entry ``[p][a]`` is what the warp that owns
    forward row ``a`` holds for diagonal ``p`` (NaN where no warp writes).
    ``sparse``: the sparse stack at window ``W``; ``u (P, R, C)``: the
    forward refined increments in the solve's frame (``u[:, r, c]`` feeds
    cell ``(r + 1, c + 1)``). Warp ``k`` (reverse rows ``i0 = 32 k + 1``
    on) owns forward rows ``a = R - i0 - t``, lane ``t`` = 0 .. 31, and
    holds ``halo`` rows above its top row (default ``W - 2``). For each
    window ``w`` it takes diagonals ``e = w W`` and ``e + 1`` at its rows
    from the sparse stack alone and recomputes ``e + 2 .. e + W - 1`` in
    the forward's operand order, row ``a - 1`` being the next row of the
    warp's column (the halo's for the top row), and the wavefront's edge
    value outside the frame. Rows before the frame and the neighbour of
    the lowest halo row are NaN, so a value whose cone leaves what the
    warp holds is NaN. The negative controls of the tests: a shorter
    ``halo``, or ``top_from_pair`` (the top row's neighbour read from the
    stored pair, not recomputed in the halo)."""
    P, R, C = u.shape
    halo = W - 2 if halo is None else halo
    dev, nan = u.device, float("nan")
    nwarps = -(-R // band.WARP)
    i0 = torch.arange(nwarps, device=dev) * band.WARP + 1
    lanes = torch.arange(band.WARP + halo, device=dev)
    rows = (R - i0)[:, None] - lanes[None, :]  # (warps, 32 + halo)
    held = rows >= 0
    at = rows.clamp(min=0)
    main = rows[:, :band.WARP]
    owned = main >= 0
    scheme = scan_solver.get_scheme(naive)
    out = u.new_full((P, R + C + 1, R + 1), nan)
    none = u.new_full((P, nwarps, 1), nan)
    for w in range(sparse.shape[1] // 2):
        e = w * W
        vals = [torch.where(held, sparse[:, 2 * w + k][:, at], nan)
                for k in (0, 1)]
        for d in range(e + 2, e + W):
            # row a - 1 is the next row of the column; the last has none
            n2, n1 = (torch.cat([v[..., 1:], none], -1) for v in vals[-2:])
            if top_from_pair:  # lane 31's neighbour: the halo's first row
                top = band.WARP
                n2[..., top - 1], n1[..., top - 1] = (vals[0][..., top],
                                                      vals[1][..., top])
            inside = (rows >= max(1, d - C)) & (rows <= min(R, d - 1))
            uu = u[:, (rows - 1).clamp(0, max(R - 1, 0)),
                   (d - rows - 1).clamp(0, C - 1)]
            edge = ((rows >= d - C) & (rows <= d)).to(u.dtype)
            vals.append(torch.where(
                inside, scheme(n2, n1, vals[-1], uu),
                torch.where(held, edge, nan)))
        for k, v in enumerate(vals):
            if e + k <= R + C:
                out[:, e + k, main[owned]] = v[:, :, :band.WARP][:, owned]
    return out


def inc_adjoint_ckpt_banded_plain(inc: torch.Tensor, sparse: torch.Tensor,
                                  dyadic_order: int = 0, naive: bool = False,
                                  H=None, Wc=None, W=None, halo=None,
                                  top_from_pair: bool = False) -> torch.Tensor:
    """K8's band kernel in plain PyTorch, for the tests: the forward values
    each warp recomputes from the sparse stack at window ``W`` (default
    :func:`window`) with its halo (:func:`ckpt_warp_stack`, on the forward
    increments by the kernel's index arithmetic), and the reverse frame
    swept from a row 0 of 1s in bands of ``H`` rows and chunks of ``Wc``
    columns (default: the kernel's, :data:`.band.BAND_ROWS` and
    :data:`.band.CHUNK`), multiplied and collapsed by the kernel's lane
    arithmetic (:func:`.band.banded_adjoint`) into ``ct (P, Mb, Nb)``; then
    the exact ``1 / f^2``. Bit for bit :func:`inc_adjoint_ckpt_plain` and
    :func:`inc_adjoint_plain` on the full stack; no route runs it.
    ``halo`` and ``top_from_pair``: :func:`ckpt_warp_stack`'s negative
    controls."""
    P, Mb, Nb = inc.shape
    ct = torch.zeros_like(inc)
    if P == 0 or Mb == 0 or Nb == 0:
        return ct
    f = 2 ** dyadic_order
    if ckpt_kernel(dyadic_order, window() if W is None else W) != "band":
        raise ValueError(f"K8's band kernel holds a base row's f = {f} rows "
                         f"in one warp and a window's halo of W - 2 rows one "
                         f"a lane of it")
    R, C = band.frame(Mb, Nb, dyadic_order)
    fwd = ckpt_warp_stack(sparse, band.increments(inc, f, 0, R, False),
                          window() if W is None else W, naive, halo,
                          top_from_pair)
    out = ct.transpose(-1, -2) if Mb > Nb else ct  # the solve's frame
    band.banded_adjoint(band.increments(inc, f, 0, R, True), fwd,
                        inc.new_ones(P, C + 1), out, 0, R, f, naive,
                        H or band.BAND_ROWS, Wc or band.CHUNK)
    return ct / (f * f)


def ckpt_kernel(dyadic_order: int, W: int) -> str:
    """K8's kernel at a refinement and window: ``"band"`` (the band kernel,
    whose collapse holds a base row's ``f`` refined rows in one warp and
    whose halo of ``W - 2`` rows one lane a row) while ``f <= 32`` and ``W
    <= 34``, else ``"one_block"``."""
    fits = (band.adjoint_kernel(dyadic_order) == "band"
            and W - 2 <= band.WARP)
    return "band" if fits else "one_block"


def _check(inc: torch.Tensor, what: str) -> None:
    if inc.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {inc.device}")
    if inc.dtype not in _FNS:
        raise ValueError(f"{what}: dtype {inc.dtype}; expected "
                         "torch.float32 or torch.float64")
    if inc.dim() != 3:
        raise ValueError(f"{what}: expected (P, Mb, Nb); got shape "
                         f"{tuple(inc.shape)}")
    if not inc.is_contiguous():
        raise ValueError(f"{what}: the increment grid must be contiguous")
    if inc.shape[0] >= 2 ** 31:
        raise ValueError(f"{what}: {inc.shape[0]} pairs exceed one launch")


@spanned("sk.op.inc_wavefront")
def inc_solve_final(inc: torch.Tensor, dyadic_order: int = 0,
                    naive: bool = False) -> torch.Tensor:
    """``K[MM, NN]`` for each pair of a ``(P, Mb, Nb)`` base increment grid."""
    if inc.device.type == "cpu":
        return inc_solve_final_plain(inc, dyadic_order, naive)
    _check(inc, "inc_solve_final")
    P, Mb, Nb = inc.shape
    if P == 0 or Mb == 0 or Nb == 0:
        # no pairs, or a length-1 path (K is its boundary, 1): no launch
        return inc.new_ones(P)
    out = torch.empty(P, dtype=inc.dtype, device=inc.device)
    R, C = band.frame(Mb, Nb, dyadic_order)
    band.launch("inc_wavefront", _FNS, COUNTS, inc, P, R, C,
                [band.per_pair(t) for t in (inc, out)],
                (Mb, Nb, 2 ** dyadic_order, band.bands(R), int(naive)))
    return out


@spanned("sk.op.inc_wavefront[stack]")
def inc_solve_stack(inc: torch.Tensor, dyadic_order: int = 0,
                    naive: bool = False):
    """K2-stack: ``(values (P,), stack)`` of a ``(P, Mb, Nb)`` base grid;
    the stack's shape is :func:`stack_shape` of the refined grid. Needs
    ``Mb, Nb >= 1`` on the card (a length-1 path has no adjoint to feed)."""
    if inc.device.type == "cpu":
        return inc_solve_stack_plain(inc, dyadic_order, naive)
    _check(inc, "inc_solve_stack")
    P, Mb, Nb = inc.shape
    if Mb == 0 or Nb == 0:
        raise ValueError("inc_solve_stack: a length-1 path has no stack")
    f = 2 ** dyadic_order
    stack = torch.empty(stack_shape(P, Mb * f, Nb * f), dtype=inc.dtype,
                        device=inc.device)
    if P == 0:
        return inc.new_ones(0), stack
    out = torch.empty(P, dtype=inc.dtype, device=inc.device)
    R, C = band.frame(Mb, Nb, dyadic_order)
    band.launch("inc_wavefront[stack]", _STACK_FNS, STACK_COUNTS, inc, P, R,
                C, [band.per_pair(t) for t in (inc, out, stack)],
                (Mb, Nb, f, band.bands(R), int(naive)))
    return out, stack


@spanned("sk.op.adjoint_collapse_inc")
def inc_adjoint(inc: torch.Tensor, stack: torch.Tensor,
                dyadic_order: int = 0, naive: bool = False) -> torch.Tensor:
    """K3<inc>: the gradient ``(P, Mb, Nb)`` of each pair's corner in its
    base increments, given the forward ``stack`` of :func:`inc_solve_stack`
    (unit upstream cotangent; the caller scales by its ``g``)."""
    if inc.device.type == "cpu":
        return inc_adjoint_plain(inc, stack, dyadic_order, naive)
    _check(inc, "inc_adjoint")
    P, Mb, Nb = inc.shape
    f = 2 ** dyadic_order
    if Mb == 0 or Nb == 0 or P == 0:
        return torch.zeros_like(inc)
    _build.check_rows(min(Mb, Nb) * f, inc.element_size(), "inc_adjoint")
    if (stack.shape != stack_shape(P, Mb * f, Nb * f)
            or stack.dtype != inc.dtype or stack.device != inc.device
            or not stack.is_contiguous()):
        raise ValueError("inc_adjoint: stack must be a contiguous "
                         f"{stack_shape(P, Mb * f, Nb * f)} tensor of the "
                         "grid's dtype and device")
    ct = torch.zeros_like(inc)
    _build.launch("adjoint_collapse_inc", _ADJOINT_FNS, ADJOINT_COUNTS, inc,
                  inc.data_ptr(), stack.data_ptr(), ct.data_ptr(), P, Mb, Nb,
                  f, int(naive))
    return ct / (f * f)


@spanned("sk.op.inc_wavefront[sparse]")
def inc_solve_sparse(inc: torch.Tensor, dyadic_order: int = 0,
                     naive: bool = False):
    """K2-sparse: ``(values (P,), sparse stack)`` of a ``(P, Mb, Nb)`` base
    grid at the window :data:`CKPT_WINDOW`; the sparse stack's shape is
    :func:`sparse_shape`. Needs ``Mb, Nb >= 1`` on the card."""
    if inc.device.type == "cpu":
        return inc_solve_sparse_plain(inc, dyadic_order, naive)
    _check(inc, "inc_solve_sparse")
    W = window()
    P, Mb, Nb = inc.shape
    if Mb == 0 or Nb == 0:
        raise ValueError("inc_solve_sparse: a length-1 path has no stack")
    f = 2 ** dyadic_order
    sparse = torch.empty(sparse_shape(P, Mb * f, Nb * f), dtype=inc.dtype,
                         device=inc.device)
    if P == 0:
        return inc.new_ones(0), sparse
    out = torch.empty(P, dtype=inc.dtype, device=inc.device)
    R, C = band.frame(Mb, Nb, dyadic_order)
    band.launch("inc_wavefront[sparse]", _SPARSE_FNS, SPARSE_COUNTS, inc, P,
                R, C, [band.per_pair(t) for t in (inc, out, sparse)],
                (Mb, Nb, f, W, band.bands(R), int(naive)))
    return out, sparse


@spanned("sk.op.adjoint_ckpt")
def inc_adjoint_ckpt(inc: torch.Tensor, sparse: torch.Tensor,
                     dyadic_order: int = 0,
                     naive: bool = False) -> torch.Tensor:
    """K8: the gradient ``(P, Mb, Nb)`` of each pair's corner in its base
    increments from the sparse stack of :func:`inc_solve_sparse` (at the
    same :data:`CKPT_WINDOW`); equal to :func:`inc_adjoint` on the full
    stack, bit for bit. The kernel by :func:`ckpt_kernel`; the band kernel
    through :func:`.band.launch`."""
    if inc.device.type == "cpu":
        return inc_adjoint_ckpt_plain(inc, sparse, dyadic_order, naive)
    _check(inc, "inc_adjoint_ckpt")
    W = window()
    P, Mb, Nb = inc.shape
    f = 2 ** dyadic_order
    if Mb == 0 or Nb == 0 or P == 0:
        return torch.zeros_like(inc)
    R, C = band.frame(Mb, Nb, dyadic_order)
    one_block = ckpt_kernel(dyadic_order, W) == "one_block"
    if one_block:
        _build.check_rows(R, inc.element_size(), "inc_adjoint_ckpt")
    want = sparse_shape(P, Mb * f, Nb * f)
    if (sparse.shape != want or sparse.dtype != inc.dtype
            or sparse.device != inc.device or not sparse.is_contiguous()):
        raise ValueError(f"inc_adjoint_ckpt: the sparse stack must be a "
                         f"contiguous {want} tensor of the grid's dtype and "
                         "device")
    ct = torch.zeros_like(inc)
    if one_block:
        scratch = torch.empty(P, W, R + 1, dtype=inc.dtype, device=inc.device)
        _build.launch("adjoint_ckpt[one block]", _CKPT_ONE_BLOCK_FNS,
                      CKPT_COUNTS, inc, inc.data_ptr(), sparse.data_ptr(),
                      scratch.data_ptr(), ct.data_ptr(), P, Mb, Nb, f, W,
                      int(naive), key="one_block")
        return ct / (f * f)
    band.launch("adjoint_ckpt", _CKPT_FNS, CKPT_COUNTS, inc, P, R, C,
                [band.per_pair(t) for t in (inc, sparse, ct)],
                (Mb, Nb, f, W, band.bands(R), int(naive)))
    return ct / (f * f)
