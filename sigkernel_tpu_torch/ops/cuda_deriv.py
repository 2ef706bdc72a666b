"""K5: the triple wavefront of the derivative Gram
(``csrc/deriv_wavefront.cu``).

K5 replaces ``sigkernel_tpu/ops/pallas_derivatives.py``'s ``_deriv_kernel``
(float) and ``_deriv_kernel_df`` (double): the corners of ``(K, K_diff,
K_diffdiff)`` of each pair, swept together over three base increment grids
``(P, Mb, Nb)`` (of the static-kernel Gram and of its first and second
directional derivatives) refined by ``2^dyadic_order`` in the kernel.
Forward only, as the TPU kernels are. It is the band-pipelined wavefront of
``csrc/band_sweep.cuh`` with a three-grid source: a block per (pair, band of
:data:`.cuda_blocked.BAND_ROWS` rows), each lane holding the three states of
its row and the hand-offs carrying three values a column
(:func:`deriv_solve_banded_plain` emulates that decomposition on any
device, for the tests). No row bound applies; a launch holds at most
:func:`.cuda_gen.gen_chunk` pairs of three-value scratch, so that the
bands' hand-off scratch stays within :data:`.cuda_gen.SCRATCH_BYTES`.

The wrapper launches the kernel for CUDA tensors and takes its plain
version (:func:`deriv_solve_final_plain`) only for CPU tensors. ``COUNTS``
holds the kernel launches per dtype and the calls of the plain version.
"""
from __future__ import annotations

import torch

from . import _build, cuda_blocked, cuda_gen, scan_solver
from ..tracing import spanned
from ..utils import dyadic_refine

COUNTS = {"float32": 0, "float64": 0, "plain": 0}

_FNS = {torch.float32: "sk_deriv_wavefront_f32",
        torch.float64: "sk_deriv_wavefront_f64"}


def deriv_solve_final_plain(inc, inc_d, inc_dd, dyadic_order: int = 0):
    """Plain version: in the kernel's frame (the grids transposed when
    ``Mb > Nb``; the f2/f3 terms swap under a transpose and round
    otherwise), refine the three grids, then
    :func:`.scan_solver.solve_derivatives_final`."""
    COUNTS["plain"] += 1
    grids = (inc, inc_d, inc_dd)
    if inc.shape[-2] > inc.shape[-1]:
        grids = tuple(g.transpose(-1, -2) for g in grids)
    return scan_solver.solve_derivatives_final(
        *(dyadic_refine(g, dyadic_order) for g in grids))


def _deriv_tile(north, west, u):
    """One band's chunk of the three states at once: the ``(3, P, h + 1, w +
    1)`` tile whose row 0 is ``north`` ``(3, P, w + 1)`` and whose column 0
    below it is ``west`` ``(3, P, h)``, swept by anti-diagonals of
    :func:`.scan_solver.derivative_cell` over the increments ``u (3, P, h,
    w)``."""
    _, P, h, w = u.shape
    tile = u.new_empty(3, P, h + 1, w + 1)
    tile[:, :, 0, :] = north
    tile[:, :, 1:, 0] = west
    for p in range(2, h + w + 1):
        i = torch.arange(max(1, p - w), min(h, p - 1) + 1, device=u.device)
        tile[:, :, i, p - i] = torch.stack(scan_solver.derivative_cell(
            tile[:, :, i - 1, p - i - 1], tile[:, :, i - 1, p - i],
            tile[:, :, i, p - i - 1], u[:, :, i - 1, p - i - 1]))
    return tile


def deriv_solve_banded_plain(inc, inc_d, inc_dd, dyadic_order: int = 0,
                             H=cuda_blocked.BAND_ROWS, Wc=cuda_blocked.CHUNK,
                             handoff=None):
    """K5's band decomposition in plain PyTorch, for the tests: the three
    grids' refined increments by the kernel's index arithmetic
    (:func:`.cuda_blocked._band_increments`: the frame transposed when
    ``Mb > Nb``, the exact ``1 / f^2``) swept in bands of ``H`` rows, one
    after another, each in chunks of ``Wc`` columns, a chunk taking the
    three states of its north row from the band above's hand-off row ((1,
    0, 0) for band 0) and of its west column from the chunk before.
    ``handoff`` (a negative control) maps each hand-off row ``(3, P, C +
    1)`` between two bands. Returns the corners ``(K, K_diff, K_diffdiff)``,
    bit for bit :func:`deriv_solve_final_plain`; no route runs it."""
    P, Mb, Nb = inc.shape
    if P == 0 or Mb == 0 or Nb == 0:
        return inc.new_ones(P), inc.new_zeros(P), inc.new_zeros(P)
    f = 2 ** dyadic_order
    R, C = cuda_blocked.frame(Mb, Nb, dyadic_order)
    u = torch.stack([cuda_blocked._band_increments(g, f, 0, R, False)
                     for g in (inc, inc_d, inc_dd)])
    edge = inc.new_tensor([1.0, 0.0, 0.0])[:, None, None]  # (1, 0, 0)
    above = edge.expand(3, P, C + 1)
    for i0 in range(1, R + 1, H):  # band by band
        h = min(H, R - i0 + 1)
        below = edge.expand(3, P, C + 1).clone()  # the band's hand-off row
        west = edge.expand(3, P, h)
        for c0 in range(1, C + 1, Wc):  # chunk by chunk
            w = min(Wc, C - c0 + 1)
            tile = _deriv_tile(above[:, :, c0 - 1:c0 + w], west,
                               u[:, :, i0 - 1:i0 - 1 + h, c0 - 1:c0 - 1 + w])
            west = tile[:, :, 1:, -1]
            below[:, :, c0:c0 + w] = tile[:, :, -1, 1:]
        above = below if handoff is None or i0 + h > R else handoff(below)
    return tuple(above[:, :, C])


def _check(inc, inc_d, inc_dd) -> None:
    """Raise unless the three grids are contiguous ``(P, Mb, Nb)`` CUDA
    tensors of one shape, dtype and card, none requiring a gradient."""
    for name, t in (("inc", inc), ("inc_d", inc_d), ("inc_dd", inc_dd)):
        if t.device.type != "cuda" or t.device != inc.device:
            raise ValueError(f"deriv_solve_final: {name} is on {t.device}")
        if t.dtype not in _FNS or t.dtype != inc.dtype:
            raise ValueError(f"deriv_solve_final: {name} has dtype {t.dtype}; "
                             "expected one of torch.float32, torch.float64 "
                             "for all three grids")
        if t.dim() != 3 or t.shape != inc.shape or not t.is_contiguous():
            raise ValueError("deriv_solve_final: the grids must be "
                             "contiguous (P, Mb, Nb) tensors of one shape")
        if t.requires_grad and torch.is_grad_enabled():
            raise ValueError("deriv_solve_final: the CUDA kernel is forward "
                             f"only, and {name} requires a gradient")


@spanned("sk.op.deriv_wavefront")
def deriv_solve_final(inc, inc_d, inc_dd, dyadic_order: int = 0):
    """``(K, K_diff, K_diffdiff)`` corners, each ``(P,)``, of three
    ``(P, Mb, Nb)`` base increment grids."""
    if inc.device.type == "cpu":
        return deriv_solve_final_plain(inc, inc_d, inc_dd, dyadic_order)
    _check(inc, inc_d, inc_dd)
    P, Mb, Nb = inc.shape
    if P == 0 or Mb == 0 or Nb == 0:
        # no pairs, or a length-1 path (the boundary values): no launch
        return inc.new_ones(P), inc.new_zeros(P), inc.new_zeros(P)
    R, C = cuda_blocked.frame(Mb, Nb, dyadic_order)
    nbands = -(-R // cuda_blocked.BAND_ROWS)
    size = inc.element_size()
    # the hand-offs carry three values a column; a launch's blocks fit an int
    chunk = min(cuda_gen.gen_chunk(P, R, C, 3 * size), (2 ** 31 - 1) // nbands)
    out = torch.empty(P, 3, dtype=inc.dtype, device=inc.device)
    scratch = torch.empty(chunk * (nbands - 1) * (C + 1) * 3, dtype=inc.dtype,
                          device=inc.device)
    counters = torch.empty(chunk * nbands + 1, dtype=torch.int32,
                           device=inc.device)
    grid = Mb * Nb * size
    for s in range(0, P, chunk):
        counters.zero_()
        _build.launch("deriv_wavefront", _FNS, COUNTS, inc,
                      *(g.data_ptr() + grid * s for g in (inc, inc_d, inc_dd)),
                      out.data_ptr() + 3 * size * s, scratch.data_ptr(),
                      counters.data_ptr(), min(chunk, P - s), Mb, Nb,
                      2 ** dyadic_order, nbands)
    return tuple(out.t().contiguous())
