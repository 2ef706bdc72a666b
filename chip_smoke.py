#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU through its CUDA kernels, the
forward path, the adjoint (training) path, the derivative Gram, CHSIC, the
Linear generator and paths too long for one block, and check it.

Run from the repository root, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

0. Device: the card's name and power limit, torch/CUDA versions, and the
   build of the kernels from ``sigkernel_tpu_torch/csrc`` (nvcc at first use).
1. Each kernel against its plain PyTorch version on the card, over the README
   quick-start shape (both orientations), 8 pairs at length 1024 and a
   length-1 path, float32 and float64: K1 (``rbf_gen_wavefront``), K2
   (``inc_wavefront``) and K6 (``linear_gen_wavefront``) x {order-2, naive}
   x dyadic {0, 1, 2} (one pair at length 2048 too); K5
   (``deriv_wavefront``, order-2 only, on the RBF kernel's derivative
   grids; at length 1024, dyadic 2 and length 2048, dyadic 1 its shorter
   refined side is 4,092 and 4,094 rows); the adjoint's kernels K1-stack,
   K2-stack, K3 (``adjoint_collapse`` gen and inc) and K4 (``rbf_dd_vjp``)
   x {order-2, naive} x dyadic {0, 1, 2} (order-2 only at length 1024);
   then, at a forced small stripe height (three stripes, the last one
   short; 1,500 rows at length 1024, dyadic 2), the long-path kernels: K7
   (``stripe_wavefront``, forward and flipped), K7-stack and K3<inc,
   boundary> (``adjoint_collapse_stripe``) stripe by stripe, the stripe
   chain against K2 and the striped adjoint against K3<inc>; K2-sparse
   (``inc_wavefront[sparse]``) against its plain version and K8
   (``adjoint_ckpt``) against K3<inc> (bit for bit) and its plain version;
   then the band decomposition at its edges (``BAND_CASES``: ragged rows
   and columns, a zero-padded last adjoint stripe, one pair shorter than a
   band, 5,000 blocks, dyadic 5), K7, K7-stack and K3<inc, boundary> (on
   the forward stripe's K7-stack) bit for bit, and at dyadic 6 K3<inc,
   boundary> on its one-block kernel, by its counter; then K1, K1-stack
   and K3<gen> (the band kernel with the RBF generator, K3<gen>'s walking
   the columns backward) bit for bit at the edges of their band
   decomposition (``GEN_BAND_CASES``: frames of 1 to 4,092 rows, transposed
   pairs, D 1 and 5, dyadic 0-3 and 5, 3,000 pairs), and at dyadic 6
   K3<gen> on its one-block kernel, by its counter; then K5 on its band
   kernel (three states a row, the hand-offs carrying three values a
   column) bit for bit at the edges of its band decomposition
   (``DERIV_BAND_CASES``: frames of 1 to 192 rows and, in float64, one
   pair of 8,184 rows past the earlier one-block kernel's bound, transposed
   pairs, D 1 and 5, dyadic 0-3, 5 and 6, 3,000 pairs; K5 on the problems
   above is checked bit for bit too); then K8 on its band
   kernel (each warp recomputing its rows' forward values from the sparse
   stack, with a halo) bit for bit against its plain version and K3<inc>
   at the edges of its decomposition (``CKPT_BAND_CASES``: frames smaller
   than a window, W 2, 3, 5 and 8, a halo reaching row 0, a short last
   band, dyadic 0-2 and 5, 3,000 pairs), and at dyadic 6 K8 on its
   one-block kernel, by its counter; K8's timed calls (below) are checked
   bit for bit too; then K2, K2-stack and K2-sparse on their band kernel
   (a whole frame a pair over its base grid; K2-sparse writing the sparse
   stack's stored diagonals) bit for bit against their plain versions,
   their emulations and a second launch at the edges of its decomposition
   (``INC_BAND_CASES``: frames of 1 to 212 rows, a transposed pair, R 37
   against C 301, f 1 to 64, W 2, 3 and 8, 3,000 pairs, and K2 in float
   at 19,376 rows, past the one-block bound). K2, K2-stack and K2-sparse
   are checked bit for bit against their plain versions wherever phase 1
   runs them. Last, K9 (``rbf_gen_increments``, the RBF increment grids of
   the ``inc`` family's gradient route) bit for bit against its plain
   version and a second launch, one launch a call, at ``INCREMENT_CASES``
   (``longpath.scoring``'s 560 pairs of length 1024, dim 5; ragged frames,
   D 1 to 13, M or N = 2); and K10 (``linear_gen_increments``, the Linear
   increment grids) bit for bit against its plain version and a second
   launch, K11 (``linear_dd_vjp``, their VJP to the scaled increments)
   within ``LINEAR_VJP`` of its plain version and bit for bit against a
   second launch, one launch a call each, at ``LINEAR_CASES``
   (``northstar_linear.train``'s 128-pair chunk of length 1024, dim 3;
   ragged frames, D 1 to 13, M or N = 2).
2. The forward main path at the north-star size: ``SigKernel(RBFKernel(1.0),
   dyadic_order=1)`` on X, Y of shape (100, 1024, 3), float64 and float32:
   ``compute_Gram(X, X, sym=True)``, ``compute_Gram(X, Y)``,
   ``compute_mmd(X, Y)`` and ``sig_gram_lincomb`` with ``pair_chunk=128``.
3. ``sym=True`` Grams at batch 50, length 100: ``LinearKernel`` (K6) and
   ``RBF_SQR_Kernel`` (K2).
4. ``hypothesis_test`` at batch 32, length 200, dyadic 1.
5. The training path at the north-star size: ``sig_gram_lincomb(RBFKernel
   (1.0), X, Y, W, dyadic_order=1, pair_chunk=128).backward()`` with X, Y and
   sigma requiring gradients, in three grades: float64 paths with
   ``grad_solver="f32"``, float32 paths, and float64 paths with the default
   (float64) grade.
6. ``MMDFlow(RBFKernel(1.0), dyadic_order=1).fit`` for 5 steps at batch 32,
   length 200, float64; and a ``LinearKernel`` ``sym=True`` Gram at batch
   50, length 100 with ``.backward()`` (K6 values; K10's grids, K2-stack,
   K3<inc> and K11).
7. The derivative Gram at the north-star size: ``compute_kernel_and_
   derivatives_Gram(X, Y, gamma, max_batch=16)`` of ``SigKernel(RBFKernel
   (1.0), dyadic_order=1)``, float64 and float32 (K5); and one float64
   pair of length 1024 at dyadic 3 (8,184 refined rows, past the earlier
   one-block kernel's bound), on K5 too, equal to ``solver="scan"``.
8. ``sig_chsic`` at the long-path stress configuration: m = 50 paths of
   length 1024, dim 5, dyadic 2, float64 (three ``sym`` Grams through K1).
9. The Linear Gram at the north-star size: ``SigKernel(LinearKernel(1.0),
   dyadic_order=1).compute_Gram(X, Y)``, float64 and float32, one K6 launch
   each; then, uncounted, the route it replaces (K2 on the torch-built
   increment grid, ``max_batch=25``), timed beside it.
10. Long paths, forward: RBF Grams of paths of length 5,001, dim 5,
    dyadic 2 (a 20,000 x 20,000 refined grid, past the one-block row bound
    in both dtypes): ``sig_gram(sym=True)`` of 16 paths and ``sig_mmd`` of
    8 vs 8 paths, ``max_batch=8``, float64 (3 stripes) and float32 (2),
    through K7; two pairs against the plain stripes.
11. Long paths, training: ``sig_mmd(X, Y, max_batch=4, pair_chunk=16)
    .backward()`` at phase 10's size, 8 vs 8 paths, gradients in X and
    sigma, in the float64 grade and with ``grad_solver="f32"``: K9's grids
    and K7 forward, then the striped adjoint (K9's grids, K7 boundaries,
    K7-stack, K3<inc, boundary>) and K4;
    a sub-problem at a forced small stripe height against the plain tier.
12. The sparse-checkpoint adjoint: ``sig_scoring_rule(X, y).backward()``
    at BASELINE config 4's size (len 1,024, dyadic 2, dim 5; X 32 paths, y
    one: 560 pairs), float64, through K9's grids, K2 and K2-sparse -> K8 and
    K4; float32 paths
    of length 2,049 (X 8, y 1) on the same route; X 100 paths, whose
    5,050-pair sym tile at the default ``max_batch`` is built and solved
    chunk by chunk. The counted runs patch both ckpt gates (``SPARSE_GATE``)
    so that they take the sparse route whatever the gates pick. Then,
    uncounted, the same float64 call on the full-stack routes (the gates'
    pair counts patched to 1: the generator, K1-stack -> K3<gen> -> K4,
    and the increment grid, K2-stack -> K3<inc>)
    and the sparse route again, with times and peaks; and the gates'
    crossovers (``gate_sweep``): the scoring rule and a 32 x 32 lincomb at
    lengths where one chunk holds 5 to 128 full stacks, and phase 5's
    float64-grade lincomb, each on the sparse route and the full generator
    route in turns, and on the full increment-grid route too where a chunk
    holds ``GATE_INC_FROM`` full stacks or more.

The launch counters are zeroed before phases 2-4 and before each later
phase, and read after each: every kernel of the phase must have launched
and no plain version may have run. The checks of those phases against plain
versions come after the counters are read, then each kernel is timed beside
its plain version at 128 pairs, length 1024, dyadic 1, dim 3 (the stripe
kernels at phase 10's grid; K7 at both the forward's and the adjoint's
stripe height, two entries; K2-sparse and K8 also at phase 12's shape, 128
pairs of length 1024, dyadic 2, dim 5, a second entry each; K9, and K4 in
a second entry, at ``longpath.scoring``'s call, 560 pairs of length 1024,
dim 5; K10 and K11 beside the PyTorch grid and its autograd VJP, which
they replace; K1, K1-stack, K3<gen>, K8, K2, K2-stack and K2-sparse beside their
times before the band kernel). The last three
lines of the output are the card's ``nvidia-smi`` line, one JSON object
describing the kernels (each with its launches on the main path, its
largest error against its plain version, its time and its plain version's,
its bound: the larger of the bytes it must move over 3.35 TB/s and its
operations over the card's non-tensor peak in its dtype, and for K9, K10
and K11 the time of the PyTorch ops they replace, ``library_ms``), and the
result line
``{"ok": true, "device": {...}}``.
"""
import json
import math
import subprocess
import sys
import time

# Kernel against plain version, max relative error. float64: the port's
# parity bar. float32: the kernels round in the plain versions' op order,
# but exp may round differently, and the double-difference cancellation
# amplifies that more on longer paths.
F64_RTOL = 1e-10
F32_RTOL_SMALL = 1e-4
F32_RTOL_LONG = 1e-3  # paths of length >= 1024
# float32 against float64 at the north star, max abs error over max |K|:
# the f32 sweep's own drift (it adds millions of rounding errors of one
# sign; not a kernel property)
F32_VS_F64 = 1e-1
# Gradients and stacks against their plain versions, max |err| / max |ref|
# (an entry-wise relative error means nothing for entries near 0). float64:
# the port's bar. float32: K1-stack, K2-stack and K3 round as their plain
# versions do (bit-equal so far); K4 sums its rows in another order than the
# plain version's matrix products.
GRAD_F64 = 1e-10
GRAD_F32 = 1e-4
# Gradients through the whole chain against the plain tier on the card: the
# float64 grade within the port's gradient bar; the float32 grades against
# the float64 plain adjoint within the float32 chain's own error at a 2046^2
# grid, about 3e-2 on the H100 (the JAX package measured 2.69e-2 there,
# docs/VALIDATION.md:33).
CHAIN_F64 = 1e-9
CHAIN_F32 = 1e-1
# K5 and K6 against their plain versions: no exp in either kernel, so the
# float32 bar holds at every length. K entry-wise relative; K_diff and
# K_diffdiff as max |err| / max |ref| (their entries cross 0).
NEW_F32 = 1e-4
# The derivative Gram and CHSIC on the card against the plain tier on a
# sub-problem: float64 K within the port's value bar, the derivatives within
# its gradient bar; float32 within the float32 derivative bar.
DERIV_F64 = 1e-9
DERIV_F32 = 1e-3

DEVICE = "cuda"
# phase 1: name, pairs, M, N, D, sigma, dyadic orders
PROBLEMS = [
    ("quick-start 5 pairs 10x20 d2", 5, 10, 20, 2, 0.5, (0, 1, 2)),
    ("quick-start 5 pairs 20x10 d2", 5, 20, 10, 2, 0.5, (0, 1, 2)),
    ("8 pairs 1024x1024 d3", 8, 1024, 1024, 3, 1.0, (0, 1, 2)),
    ("1 pair 2048x2048 d3", 1, 2048, 2048, 3, 1.0, (1,)),
    ("length-1 path 3 pairs 1x5 d2", 3, 1, 5, 2, 0.5, (0, 1, 2)),
]
LONG = 1024           # phase 1: the adjoint runs order-2 only from here
NORTH_STAR = (100, 1024)  # batch, length (dim 3, dyadic 1)
LINEAR = (50, 100)    # phases 3 and 6: LinearKernel batch, length
FLOW = (32, 200)      # phases 4 and 6: batch, length
DERIV_TILE = 16       # phase 7: max_batch of the derivative Gram
CHSIC = (50, 1024, 5, 2)  # phase 8: m, length, dim, dyadic order
GRID_TILE = 25        # phase 9: max_batch of the grid route K6 replaces
TIMED_PAIRS = 128     # kernel times at the north star's length
# phase 1, the long-path kernels at a forced stripe height: name, pairs, M,
# N, dim, dyadic orders, stripe height in base rows (three stripes, the last
# one short; order-2 only at length 1024)
STRIPE_PROBLEMS = [
    ("stripes 5 pairs 10x20 d2", 5, 10, 20, 2, (0, 1, 2), 4),
    ("stripes 5 pairs 20x10 d2", 5, 20, 10, 2, (0, 1, 2), 4),
    ("stripes 2 pairs 1024x1024 d5", 2, 1024, 1024, 5, (2,), 375),
]
CKPT_WINDOWS = (5, None)  # phase 1: K8's window (None: the module's own)
# phase 1, the band decomposition of K7, K7-stack and K3<inc, boundary>
# (bands of 128 rows, one block each; hand-offs in chunks of 32 columns):
# name, pairs, M, N, dim, dyadic order, row0, rows, flip (K7's), naive.
# Ragged rows and C (R 212, C 280: a short last band and chunk), the striped
# adjoint's zero-padded last stripe (bands wholly past the frame), one pair
# with rows < 128, more blocks than the card holds at once (2,500 pairs x 2
# bands = 5,000 blocks of 128 threads), and dyadic 5 (a base row's 32 rows
# are one warp of K3<inc, boundary>'s collapse; R 192, C 256, both frames)
BAND_CASES = [
    ("ragged rows and C", 3, 71, 54, 3, 2, 0, 200, True, True),
    ("ragged rows and C", 3, 71, 54, 3, 2, 0, 200, False, False),
    ("zero-padded last stripe", 3, 71, 54, 3, 2, 208, 280, True, False),
    ("zero-padded last stripe", 3, 71, 54, 3, 2, 208, 280, False, True),
    ("one pair, rows < 128", 1, 41, 60, 2, 0, 0, 40, True, True),
    ("5,000 blocks: 2,500 pairs of length 64", 2500, 64, 64, 3, 2, 0, 252,
     False, False),
    ("dyadic 5: a base row is a whole warp", 3, 9, 7, 3, 5, 0, 192, False,
     False),
    ("dyadic 5, zero-padded", 3, 7, 9, 3, 5, 128, 192, True, True),
]
# phase 1, K1, K1-stack and K3<gen> on the band kernel (a whole frame a pair,
# bands of 128 rows from a row 0 of 1s, the RBF increments generated a base
# column a lane; K3<gen> the reverse frame, its columns walked backward) at
# its edges, bit for bit: name, pairs, M, N, dim, dyadic order. The frame's
# rows R = (min(M, N) - 1) 2^dyadic: 1, 31, 32, 33, 128 (one full band), 129
# (a second band of one row), 2,046 (the timed shape) and 4,092 (phase 8's);
# transposed pairs (M > N: K3<gen>'s ct is written transposed); D = 1 and
# 5; dyadic 0-3 and 5 (a base row is a whole warp of K3<gen>'s collapse);
# 3,000 pairs, more blocks than are resident; and dyadic 6, where K3<gen>
# takes its one-block kernel (counted under "one_block")
GEN_BAND_CASES = [
    ("R 1", 3, 2, 6, 2, 0),
    ("R 31", 3, 32, 40, 3, 0),
    ("R 32, D 1", 3, 33, 40, 1, 0),
    ("R 33, D 5", 3, 34, 50, 5, 0),
    ("R 128: one full band", 3, 65, 70, 3, 1),
    ("R 129: a band of one row", 3, 130, 140, 3, 0),
    ("a transposed pair (M > N)", 3, 70, 40, 3, 1),
    ("dyadic 3", 3, 9, 12, 5, 3),
    ("dyadic 5: a base row is a whole warp, transposed", 3, 9, 7, 3, 5),
    ("R 2,046: the timed shape", 2, 1024, 1024, 3, 1),
    ("R 4,092: phase 8's frame", 1, 1024, 1024, 5, 2),
    ("3,000 pairs", 3000, 17, 17, 3, 2),
    ("dyadic 6: K3<gen>'s one-block kernel", 3, 4, 5, 3, 6),
]
# K1, K1-stack, K3<gen>, K8, K2, K2-stack and K2-sparse at the timed shape
# in the one-block-a-pair design that the band kernel replaced (this
# script's timing, NVIDIA H100 80GB HBM3, 700.00 W), printed beside this
# run's
EARLIER_MS = {("gen", "float32"): 18.009, ("gen", "float64"): 26.026,
              ("gen_stack", "float32"): 19.252,
              ("gen_stack", "float64"): 29.214,
              ("adj_gen", "float32"): 30.547,
              ("adj_gen", "float64"): 41.361,
              ("adj_ckpt", "float32"): 28.313,
              ("adj_ckpt", "float64"): 34.390,
              ("inc", "float32"): 7.548, ("inc", "float64"): 7.634,
              ("inc_stack", "float32"): 9.250,
              ("inc_stack", "float64"): 10.368,
              ("inc_sparse", "float32"): 8.423,
              ("inc_sparse", "float64"): 8.789}
# phase 1, K5 on the band kernel (a whole frame a pair, bands of 128 rows
# from a row 0 of (1, 0, 0), the three states of a row in registers and the
# hand-offs carrying three values a column) at its edges, bit for bit
# against its plain version: name, pairs, M, N, dim, dyadic order, dtypes.
# The frame's rows R = (min(M, N) - 1) 2^dyadic: 1, 31, 32, 33, 128, 129
# and, in float64, 8,184 (phase 7's long pair, past the earlier one-block
# kernel's 4,840); a transposed pair; D 1 and 5; dyadic 0-3, 5 and 6 (f 64:
# no bound on f); 3,000 pairs, more blocks than are resident. R 1,023,
# 2,046 (the timed shape) and 4,092 are PROBLEMS' 8 pairs of length 1024,
# whose K5 is checked bit for bit too
DERIV_BAND_CASES = [
    ("R 1", 3, 2, 6, 2, 0, ("float64", "float32")),
    ("R 31", 3, 32, 40, 3, 0, ("float64", "float32")),
    ("R 32, D 1", 3, 33, 40, 1, 0, ("float64", "float32")),
    ("R 33, D 5", 3, 34, 50, 5, 0, ("float64", "float32")),
    ("R 128: one full band", 3, 65, 70, 3, 1, ("float64", "float32")),
    ("R 129: a band of one row", 3, 130, 140, 3, 0, ("float64", "float32")),
    ("a transposed pair (M > N)", 3, 70, 40, 3, 1, ("float64", "float32")),
    ("dyadic 3", 3, 9, 12, 5, 3, ("float64", "float32")),
    ("dyadic 5, transposed", 3, 9, 7, 3, 5, ("float64", "float32")),
    ("dyadic 6", 3, 4, 5, 3, 6, ("float64", "float32")),
    ("3,000 pairs", 3000, 17, 17, 3, 2, ("float64", "float32")),
    ("R 8,184: past the one-block bound", 1, 1024, 1024, 3, 3,
     ("float64",)),
]
# phase 1, K8 at the edges of its band decomposition (the reverse frame in
# bands of 128 rows, each warp recomputing its rows' forward values a
# window at a time from the sparse stack, with a halo of W - 2 rows), bit
# for bit against its plain version and K3<inc> on the full stack: name,
# pairs, M, N, dim, dyadic order, window W. Frames smaller than a window, a
# transposed pair, no diagonal recomputed (W 2), a warp whose halo reaches
# forward row 0 (R 36), a short last warp and band (R 130: a second band of
# 2 rows), dyadic 2 and 5, 3,000 pairs, and dyadic 6, where the one-block
# kernel runs (counted under "one_block"). R 4,092 (32 bands) is the long
# stripe problem's above, and the timed calls check both timed shapes bit
# for bit.
CKPT_BAND_CASES = [
    ("R 2, C 3: smaller than a window", 2, 3, 4, 3, 0, 8),
    ("transposed, W 3", 3, 15, 10, 3, 1, 3),
    ("W 2: no diagonal recomputed", 2, 11, 26, 3, 0, 2),
    ("R 36: warp 0's halo reaches row 0", 2, 37, 46, 3, 0, 8),
    ("R 130: a second band of 2 rows, W 5", 2, 131, 141, 3, 0, 5),
    ("dyadic 2, transposed", 2, 18, 13, 5, 2, 8),
    ("dyadic 5: a base row is a whole warp", 2, 3, 4, 3, 5, 8),
    ("3,000 pairs", 3000, 17, 17, 3, 2, 8),
    ("dyadic 6: the one-block kernel", 2, 3, 4, 3, 6, 8),
]
# phase 1, K2, K2-stack and K2-sparse on the band kernel (a whole frame a
# pair over its base increment grid, bands of 128 rows from a row 0 of 1s;
# K2-sparse writing the sparse stack's stored diagonals) at its edges, bit
# for bit against their plain versions and their emulations
# (cuda_solver.inc_solve_*_banded_plain), and run to run: name, pairs, M,
# N, dim, dyadic order, window W, dtypes. The frame's rows R = (min(M, N) -
# 1) 2^dyadic: 1, 31, 129 (a second band of one row), 212 (a short last
# band, transposed: M > N), R 37 against C 301; f = 1, 2, 4, 8 and 64 (the
# band modes read f at run time); W 2, 3 and 8; 3,000 pairs, more blocks
# than are resident; and, in float, 19,376 rows, past the one-block
# kernel's bound of 19,369 (K2 alone, against its plain version: its
# emulation would take minutes there)
INC_BAND_CASES = [
    ("R 1, W 2", 3, 2, 6, 2, 0, 2, ("float64", "float32")),
    ("R 31, W 3", 3, 32, 40, 3, 0, 3, ("float64", "float32")),
    ("R 129: a band of one row", 3, 130, 140, 3, 0, 8,
     ("float64", "float32")),
    ("R 212, transposed (M > N)", 2, 60, 54, 3, 2, 8, ("float64", "float32")),
    ("R 37, C 301", 2, 38, 302, 3, 0, 8, ("float64", "float32")),
    ("f 2, W 3", 3, 20, 25, 3, 1, 3, ("float64", "float32")),
    ("f 8", 3, 9, 12, 5, 3, 2, ("float64", "float32")),
    ("f 64", 2, 4, 5, 3, 6, 8, ("float64", "float32")),
    ("3,000 pairs", 3000, 17, 17, 3, 2, 8, ("float64", "float32")),
    ("R 19,376: past the one-block bound", 1, 4845, 4846, 2, 2, 8,
     ("float32",)),
]
# the largest frame (rows) at which the K2 emulations run in phase 1
# (order-2 only: the naive scheme changes no index arithmetic)
INC_EMULATE_ROWS = 1000
# phase 1, K4 (one pass over each pair's cells in bands of 64 rows, a warp
# 128 columns of a chunk of 1024, 32 and 256 past D = 8) at its edges, bit for
# bit against its emulation (incvjp.rbf_dd_vjp_pairs_tiled_plain), twice
# (run-to-run identity), and against its plain version within GRAD_F64 /
# GRAD_F32, on ct from the chain (K1-stack -> K3<gen>, dyadic 1): name,
# pairs, M, N, dim, dtypes. A short last band and two warps of columns; M >
# N and M < N with a second chunk of columns; M = 2 and N = 2; D 1, 3, 5, 8
# and 300 (the wide kernel, past the earlier refusal at D 226 in double);
# the main path's 16-pair tail chunk at length 1024. Pair indices drawn
# with repeats.
VJP_CASES = [
    ("a short last band, two warps", 6, 70, 200, 3, ("float64", "float32")),
    ("M > N, D 1", 6, 130, 40, 1, ("float64", "float32")),
    ("M < N: a second chunk of columns, D 5", 4, 40, 1100, 5,
     ("float64", "float32")),
    ("M 2, D 8", 6, 2, 90, 8, ("float64", "float32")),
    ("N 2", 6, 90, 2, 3, ("float64", "float32")),
    ("D 300: the wide kernel", 3, 70, 300, 300, ("float64", "float32")),
    ("the 16-pair tail chunk", 16, 1024, 1024, 3, ("float64", "float32")),
]
VJP_TAIL = 16  # pairs of the tail chunk K4 is also timed at
# phase 1: K9 bit for bit against its plain version and a second launch:
# name, pairs, M, N, dim, drawn with repeats over 32 x and 33 y paths. The
# scoring cell's call (560 pairs of 1024 x 1024, D 5); M < N and M > N with
# a short last band (64 rows) and a short last chunk of columns (512); D 1;
# D 9 and 13, past the register instances (any D through __ldg); M = 2 and
# N = 2; N - 1 = 1,100 cuts a warp's span of columns
INCREMENT_CASES = [
    ("the scoring cell's call", 560, 1024, 1024, 5),
    ("M < N, a short last band", 6, 70, 200, 3),
    ("M > N, short last columns", 6, 200, 70, 3),
    ("D 1", 5, 134, 600, 1),
    ("D 9: past the register instances", 4, 90, 40, 9),
    ("D 13", 3, 40, 130, 13),
    ("M 2", 6, 2, 90, 5),
    ("N 2, D 8", 6, 90, 2, 8),
    ("a warp's span cut", 3, 66, 1101, 2),
]
SCORING_PAIRS = 560  # K9 and K4 timed at longpath.scoring's call
# phase 1: K10 bit for bit against its plain version and a second launch,
# K11 within LINEAR_VJP of its plain version (``bmm``, another order of
# sums) and bit for bit against a second launch: name, pairs, M, N, dim,
# drawn with repeats over 32 x and 33 y paths. northstar_linear.train's
# chunk (128 pairs of 1024 x 1024, D 3); the edges of K9's cases (K10 past
# D 8: any D through __ldg; K11: a second pass of coordinates)
LINEAR_CASES = ([("northstar_linear.train's chunk", 128, 1024, 1024, 3)]
                + INCREMENT_CASES[1:])
LINEAR_VJP = {"float64": 1e-13, "float32": 1e-5}
# phase 1: K3<inc, boundary> at dyadic 6 (f = 64 > 32: the one-block
# kernel, by its counter), as BAND_CASES
ONE_BLOCK_CASE = ("dyadic 6: the one-block kernel", 2, 5, 4, 3, 6, 0, 192,
                  False, True)
# phase 7: one float64 pair past the earlier one-block K5's row bound (8,184
# refined rows against 4,840), on K5's band kernel
DERIV_LONG = (1024, 3)
# phases 10-11: length, dim, dyadic order of the long paths (a 20,000 x
# 20,000 refined grid); Gram batch, MMD batch, max_batch of phase 10; pairs
# checked against the plain stripes; phase 11's max_batch and pair_chunk
LONG_PATHS = (5001, 5, 2)
LONG_FWD = (16, 8, 8, 2)
LONG_TRAIN = (4, 16)
# phase 11's check: 2 x 2 paths of this length at this forced row bound
LONG_SUB = (257, 300)
# phase 12: X batch, length, dim, dyadic order (BASELINE config 4's size),
# then float32 paths: X batch, length
CKPT = (32, 1024, 5, 2)
CKPT_F32 = (8, 2049)
CKPT_WIDE = 100  # phase 12: X batch of one run at the default max_batch
# phase 12, the ckpt gate's crossover: path length (dyadic 2) and dtype; in
# double a chunk of 8 GiB holds 5, 8, 13, 17, 64 and 128 full stacks, in
# float 64
GATE_SWEEP = ((2400, "float64"), (2000, "float64"), (1600, "float64"),
              (1400, "float64"), (724, "float64"), (512, "float64"),
              (1024, "float32"))
# phase 12's counted runs: a gate no chunk passes, so they take the sparse
# route (K2-sparse -> K8) whatever the gates pick at their size
SPARSE_GATE = 1 << 40
# seconds: a gate point whose runs all take longer is raced once, not twice
GATE_ONE_ROUND = 1.5
# full stacks a chunk from which the gate sweep races the increment grid's
# full route (K2-stack -> K3<inc>) too: K3<inc> is one block a pair, and at
# phase 12's 32 a chunk it takes about 3x the sparse route's time
GATE_INC_FROM = 64
TIMED_STRIPE_PAIRS = 16  # K7, K7-stack, K3<inc, boundary> at phase 10/11
# K8's plain version at phase 12's shape (128 pairs, R 4,092): pairs a call,
# so that its full stacks and grids (~1.1 GB a pair in double) fit the card
PLAIN_CKPT_CHUNK = 48
# the card's peak rates (NVIDIA H100 SXM data sheet, 700 W): HBM bytes/s and
# non-tensor-core FLOP/s by dtype
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def rel_err(got, want):
    return float(((got - want).abs() / want.abs()).max())


def max_rel(got, want):
    """max |got - want| / max |want| (0 for empty tensors)."""
    if not want.numel():
        return 0.0
    # in Python floats: a float32 clamp to 1e-300 would underflow to 0
    return (float((got - want).abs().max())
            / max(float(want.abs().max()), 1e-300))


def make_paths(gen, batch, length, dim, dtype):
    """``cumsum(normal) / sqrt(length)``, as the JAX benchmark makes them."""
    import torch

    z = torch.randn(batch, length, dim, generator=gen, device=DEVICE,
                    dtype=torch.float64)
    return (z.cumsum(dim=1) / math.sqrt(length)).to(dtype)


def leaf(t, dtype):
    """A fresh leaf copy of ``t`` in ``dtype`` that requires a gradient
    (``t.to(dtype)`` alone may return ``t`` itself)."""
    return t.detach().to(dtype).clone().requires_grad_()


def synced(fn):
    """``(result, seconds)`` on the host clock, synchronised."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn, reps):
    """Mean milliseconds per call over ``reps`` calls, by CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def event_call(fn):
    """``(result, milliseconds)`` of one call of ``fn``, by CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def work(kind, P, M, N, D, f, s, rows=0, W=2):
    """``(bytes, operations)`` the least a kernel call must move and do: P
    pairs of paths of lengths M, N and dim D at refinement f, values of s
    bytes; each input read once, each output written once; operations from
    the kernel's arithmetic (10 a refined cell for the order-2 scheme, 2 more
    for the adjoint's product and collapse; an RBF value from two points
    costs 6 D + 6 with exp counted as one; the increments are generated once
    a base cell, however often the kernel regenerates them). ``rows``: the
    stripe height (K7, K7-stack, K3<inc, boundary>); ``W``: K8's window."""
    Mb, Nb = M - 1, N - 1
    R, C = min(Mb, Nb) * f, max(Mb, Nb) * f
    base, cells, rbf = Mb * Nb, R * C, (6 * D + 6) * M * N
    paths = (M + N) * D * s + 2 * 8          # two paths and two indices
    stack = (R + C + 1) * (R + 1) * s
    band = rows // f * (C // f)              # a stripe's base cells
    stripe_stack = (rows + C + 1) * (rows + 1) * s
    sparse = 2 * ((R + C - 2) // W + 1) * (R + 1) * s
    b, o = {
        "gen": (paths + s, 10 * cells + 5 * base + rbf),
        "gen_stack": (paths + s + stack, 10 * cells + 5 * base + rbf),
        "inc": (base * s + s, 10 * cells + base),
        "inc_stack": (base * s + s + stack, 10 * cells + base),
        "inc_sparse": (base * s + s + sparse, 10 * cells + base),
        "adj_gen": (paths + stack + base * s, 12 * cells + 5 * base + rbf),
        "adj_inc": (2 * base * s + stack, 12 * cells + base),
        "adj_ckpt": (2 * base * s + sparse,
                     12 * cells + 10 * cells * (W - 2) // W + base),
        "vjp": (paths + base * s + (M + N) * D * s, (10 * D + 13) * M * N),
        "incr": (paths + base * s, rbf + 3 * base),
        "lincr": (paths + base * s, 2 * D * base),
        "lvjp": (paths + base * s + (M + N) * D * s, 4 * D * base),
        "deriv": (3 * base * s + 3 * s, 45 * cells + 3 * base),
        "lgen": (paths + s, 10 * cells + 2 * D * base + (M + N) * D),
        "stripe": (band * s + 2 * (C + 1) * s, 10 * rows * C + band),
        "stripe_stack": (band * s + 2 * (C + 1) * s + stripe_stack,
                         10 * rows * C + band),
        "adj_stripe": (3 * band * s + (C + 1) * s + stripe_stack,
                       12 * rows * C),
    }[kind]
    return P * b, P * o


def bound(nbytes, ops, dtype_name):
    """``(bound_ms, bound_by)``: the larger of the bytes over the card's
    memory rate and the operations over its non-tensor peak in the dtype."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = ops / PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def torch_linear_grid(X, Y, ct=None):
    """What K10 and K11 replace: the Linear grids of the pairs ``(X[p],
    Y[p])`` built in PyTorch, ``double_difference(LinearKernel(1.0)
    .batch_kernel(x, y))``; given a cotangent ``ct``, built under autograd
    and differentiated to the paths and ``scale`` by ``torch.autograd``."""
    import torch
    import sigkernel_tpu_torch as skt
    from sigkernel_tpu_torch.utils import double_difference

    if ct is None:
        return double_difference(skt.LinearKernel(1.0).batch_kernel(X, Y))
    with torch.enable_grad():
        x, y = X.detach().requires_grad_(), Y.detach().requires_grad_()
        s = torch.tensor(1.0, dtype=X.dtype, device=X.device,
                         requires_grad=True)
        dd = double_difference(skt.LinearKernel(s).batch_kernel(x, y))
        return torch.autograd.grad(dd, [x, y, s], ct)


def deriv_grids(kernel, X, Y, gamma, ii, jj):
    """K5's three base increment grids for the pairs ``(X[ii[p]],
    Y[jj[p]])`` along ``gamma[ii[p]]``: the static kernel and its first and
    second directional derivatives (nested jvp, as the estimator builds
    them), double-differenced."""
    import torch
    from sigkernel_tpu_torch.utils import double_difference

    y, g = Y[jj], gamma[ii]

    def first(x):
        return torch.func.jvp(lambda z: kernel.batch_kernel(z, y), (x,),
                              (g,))

    (G, dG), (_, ddG) = torch.func.jvp(first, (X[ii],), (g,))
    return [double_difference(t).contiguous() for t in (G, dG, ddG)]


def set_gates(routes, pairs):
    """Set both ckpt gates (``routes.CKPT_MIN_PAIRS``, K2-stack ->
    K3<inc>'s, and ``routes.GEN_CKPT_MIN_PAIRS``, the generator's) to
    ``pairs``, one count or a pair of them; return the pair they held."""
    saved = (routes.CKPT_MIN_PAIRS, routes.GEN_CKPT_MIN_PAIRS)
    routes.CKPT_MIN_PAIRS, routes.GEN_CKPT_MIN_PAIRS = (
        pairs if isinstance(pairs, tuple) else (pairs, pairs))
    return saved


def gate_sweep(gen, card, X5, Y5, grid_cls):
    """The ckpt gates' crossovers, uncounted: at each ``GATE_SWEEP`` length
    (dyadic 2, dim 5; one chunk of ``routes.STACK_BYTES`` holds 5 to 128
    full stacks) the scoring rule (X 32, y 1) and a lincomb fwd+bwd (X, Y
    32, ``pair_chunk=128``), then phase 5's float64-grade north-star lincomb
    (``X5``, ``Y5``: 128 full stacks a chunk), each on the sparse route and
    the full generator route, and, from ``GATE_INC_FROM`` full stacks a
    chunk, on the full increment-grid route (``grid_cls``, an RBF kernel
    that takes the ``inc`` family), in turns: sparse first in round 0, the
    reverse order in round 1 (no round 1 where every run took over
    ``GATE_ONE_ROUND`` seconds)."""
    import torch
    import sigkernel_tpu_torch as skt
    from sigkernel_tpu_torch.ops import routes

    dev = torch.device(DEVICE)
    saved = (routes.CKPT_MIN_PAIRS, routes.GEN_CKPT_MIN_PAIRS)

    def score(cls, X, Y, s):
        return skt.sig_scoring_rule(cls(s), X, Y[:1], dyadic_order=2)

    def lincomb(cls, X, Y, s, dyadic_order=2):
        W = torch.full((X.shape[0], Y.shape[0]), 1.0 / Y.shape[0] ** 2,
                       dtype=X.dtype, device=dev)
        return skt.sig_gram_lincomb(cls(s), X, Y, W,
                                    dyadic_order=dyadic_order, pair_chunk=128)

    def race(label, fn, X0, Y0, pairs, with_inc):
        plan = [("sparse", skt.RBFKernel), ("full", skt.RBFKernel)]
        if with_inc:
            plan.append(("full K3<inc>", grid_cls))
        times, outs = {route: [] for route, _ in plan}, {}
        for rnd in range(2):
            if rnd and min(min(t) for t in times.values()) > GATE_ONE_ROUND:
                break  # long runs: a second round adds no warm-up
            for route, cls in (plan if rnd == 0 else plan[::-1]):
                set_gates(routes, SPARSE_GATE if route == "sparse" else 1)
                X, Y = leaf(X0, X0.dtype), Y0.detach()
                s = torch.tensor(1.0, dtype=X.dtype, device=dev,
                                 requires_grad=True)
                torch.cuda.reset_peak_memory_stats()
                _, sec = synced(lambda: fn(cls, X, Y, s).backward())
                outs[route] = (X.grad, s.grad)
                times[route].append(sec)
                print(f"[12] gate: {label}, {route} route, round {rnd}: "
                      f"{sec:.3f} s, {pairs / sec:.1f} path-pairs/s, peak "
                      f"{torch.cuda.max_memory_allocated()} bytes ({card})")
        set_gates(routes, saved)
        best = {route: min(t) for route, t in times.items()}
        line = ", ".join(f"best {route} {t:.3f} s" for route, t in best.items())
        print(f"[12] gate: {label}: {line}; sparse / full "
              f"{best['sparse'] / best['full']:.3f}" + (
                  f", sparse / full K3<inc> "
                  f"{best['sparse'] / best['full K3<inc>']:.3f}"
                  if with_inc else ""))
        for route, out in outs.items():
            for t in out:
                check(bool(torch.isfinite(t).all()),
                      f"[12] gate {label}, {route}")
            if route == "full":
                continue
            errs = [max_rel(g, w) for g, w in zip(out, outs["full"])]
            print(f"[12] gate: {label}: {route} vs full: dX {errs[0]:.2e}, "
                  f"dsigma {errs[1]:.2e} apart")
            if X0.dtype == torch.float64:
                check(max(errs) <= CHAIN_F64,
                      f"[12] gate {label}, {route}: gradients")

    for L, dname in GATE_SWEEP:
        dtype = getattr(torch, dname)
        X = make_paths(gen, 32, L, 5, dtype)
        Y = make_paths(gen, 32, L, 5, dtype)
        R = (L - 1) * 4
        full = routes.chunk_pairs(1 << 40, routes.tier_bytes(
            "full", (R, R), torch.empty((), dtype=dtype).element_size()))
        at = (f"{dname} len {L} (R {R}, {full} full stacks a chunk, the "
              f"generator's gate takes "
              f"{'full' if full >= saved[1] else 'sparse'}, K3<inc>'s "
              f"{'full' if full >= saved[0] else 'sparse'})")
        with_inc = full >= GATE_INC_FROM
        race(f"sig_scoring_rule X 32, y 1, {at}", score, X, Y, 560, with_inc)
        race(f"sig_gram_lincomb 32 x 32, {at}", lincomb, X, Y, 1024,
             with_inc)
        del X, Y
        torch.cuda.empty_cache()
    A = X5.shape[0]
    race("phase 5's float64-grade lincomb (len 1024, dyadic 1, 128 full "
         "stacks a chunk)", lambda cls, X, Y, s: lincomb(cls, X, Y, s, 1),
         X5, Y5, A * A, True)
    torch.cuda.empty_cache()


def main():
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    import sigkernel_tpu_torch as skt
    from sigkernel_tpu_torch import stats
    from sigkernel_tpu_torch.ops import (_build, band, cuda_blocked,
                                         cuda_deriv, cuda_gen, cuda_lgen,
                                         cuda_solver, incvjp, routes)
    from sigkernel_tpu_torch.utils import double_difference

    # full-precision float32 matmuls (the plain versions' Grams)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    F32, F64 = torch.float32, torch.float64
    dev = torch.device(DEVICE)
    name = {F32: "float32", F64: "float64"}

    # ---- phase 0: device and build --------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[0] card: {card}")
    print(f"[0] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, "
          f"devices {torch.cuda.device_count()}")
    _, t_lib = synced(_build.library)
    built = _build.build_seconds
    print(f"[0] kernels library {_build.library_path()} ready in "
          f"{t_lib:.1f} s ({'built' if built is not None else 'cached'})")
    log = _build.library_path().parent / "nvcc.log"
    for line in log.read_text().splitlines() if log.exists() else []:
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[0] ptxas: {line.strip()}")

    # every kernel instance: (kind, dtype) -> (name, its launch counter)
    kinds = {
        "gen": ("rbf_gen_wavefront", cuda_gen.COUNTS),
        "gen_stack": ("rbf_gen_wavefront[stack]", cuda_gen.STACK_COUNTS),
        "inc": ("inc_wavefront", cuda_solver.COUNTS),
        "inc_stack": ("inc_wavefront[stack]", cuda_solver.STACK_COUNTS),
        "adj_gen": ("adjoint_collapse_gen", cuda_gen.ADJOINT_COUNTS),
        "adj_inc": ("adjoint_collapse_inc", cuda_solver.ADJOINT_COUNTS),
        "vjp": ("rbf_dd_vjp", incvjp.COUNTS),
        "deriv": ("deriv_wavefront", cuda_deriv.COUNTS),
        "lgen": ("linear_gen_wavefront", cuda_lgen.COUNTS),
        "stripe": ("stripe_wavefront", cuda_blocked.COUNTS),
        "stripe_stack": ("stripe_wavefront[stack]", cuda_blocked.STACK_COUNTS),
        "adj_stripe": ("adjoint_collapse_stripe", cuda_blocked.ADJOINT_COUNTS),
        "inc_sparse": ("inc_wavefront[sparse]", cuda_solver.SPARSE_COUNTS),
        "adj_ckpt": ("adjoint_ckpt", cuda_solver.CKPT_COUNTS),
        "incr": ("rbf_gen_increments", cuda_gen.INCREMENT_COUNTS),
        "lincr": ("linear_gen_increments", cuda_lgen.INCREMENT_COUNTS),
        "lvjp": ("linear_dd_vjp", cuda_lgen.VJP_COUNTS),
    }
    long_kinds = ("stripe", "stripe_stack", "adj_stripe", "inc_sparse",
                  "adj_ckpt")
    ctype = {F32: "float", F64: "double"}
    instances = {(k, dt): f"{kinds[k][0]}<{ctype[dt]}>"
                 for k in kinds for dt in (F32, F64)}
    max_abs = {key: 0.0 for key in instances}
    launches = {key: 0 for key in instances}

    def compare(kind, dtype, got, want, limit, label):
        check(bool(torch.isfinite(got).all()), f"{label}: non-finite")
        check(got.shape == want.shape, f"{label}: shape {tuple(got.shape)}")
        r = rel_err(got, want) if got.numel() else 0.0
        a = float((got - want).abs().max()) if got.numel() else 0.0
        max_abs[(kind, dtype)] = max(max_abs[(kind, dtype)], a)
        check(r <= limit, f"{label}: rel err {r:.3e} > {limit:.0e}")
        return r

    def compare_max(kind, dtype, got, want, limit, label):
        """As ``compare``, with max |err| / max |ref| as the measure."""
        check(bool(torch.isfinite(got).all()), f"{label}: non-finite")
        check(got.shape == want.shape, f"{label}: shape {tuple(got.shape)}")
        r = max_rel(got, want)
        a = float((got - want).abs().max()) if got.numel() else 0.0
        max_abs[(kind, dtype)] = max(max_abs[(kind, dtype)], a)
        check(r <= limit, f"{label}: max err / max ref {r:.3e} > {limit:.0e}")
        return r

    def compare_bits(kind, dtype, got, want, limit, label):
        """As ``compare_max``, and bit for bit."""
        r = compare_max(kind, dtype, got, want, limit, label)
        check(torch.equal(got, want), f"{label}: not bit-equal")
        return r

    def zero_counters():
        for _, counts in kinds.values():
            for k in counts:
                counts[k] = 0

    def read_counters(phase, expected, absent=()):
        """Add this phase's launches; every ``expected`` instance must have
        launched, no ``absent`` one, and no plain version may have run."""
        got = {key: kinds[key[0]][1][name[key[1]]] for key in instances}
        plain = sum(c["plain"] for _, c in kinds.values())
        print(f"[{phase}] launches: "
              f"{ {instances[k]: v for k, v in got.items() if v} }, "
              f"plain-version calls {plain}")
        for key in expected:
            check(got[key] > 0, f"{instances[key]} was never launched in "
                                f"phase {phase}")
        for key in absent:
            check(got[key] == 0, f"{instances[key]} launched in phase "
                                 f"{phase}: the route is not the one meant")
        check(plain == 0, f"a plain version ran in phase {phase}")
        for key, v in got.items():
            launches[key] += v

    def vjp_bits(X, Y, ii, jj, sigma, ct, label):
        """K4's per-pair outputs, twice, equal bit for bit to each other and
        to its emulation."""
        k = incvjp.rbf_dd_vjp_pairs(X, Y, ii, jj, sigma, ct)
        again = incvjp.rbf_dd_vjp_pairs(X, Y, ii, jj, sigma, ct)
        check(all(torch.equal(a, b) for a, b in zip(k, again)),
              f"{label}: two launches differ")
        e = incvjp.rbf_dd_vjp_pairs_tiled_plain(X, Y, ii, jj, sigma, ct)
        check(all(torch.equal(a, b) for a, b in zip(k, e)),
              f"{label}: not bit-equal to its emulation")

    # ---- phase 1: kernels against their plain versions ------------------
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    gamma_gen = torch.Generator(device=DEVICE).manual_seed(3)
    t_phase = time.perf_counter()
    for pname, P, M, N, D, sigma, orders in PROBLEMS:
        X64 = make_paths(gen, P, M, D, F64)
        Y64 = make_paths(gen, P, N, D, F64)
        G64 = make_paths(gamma_gen, P, M, D, F64)
        ii = torch.arange(P, device=dev)
        jj = ii.flip(0)  # a non-identity pairing exercises the index arrays
        long = max(M, N) >= LONG
        rbf = skt.RBFKernel(sigma)
        for dtype in (F64, F32):
            X, Y, G = X64.to(dtype), Y64.to(dtype), G64.to(dtype)
            inc = double_difference(
                rbf.batch_kernel(X[ii], Y[jj])).contiguous()
            limit = (F64_RTOL if dtype == F64 else
                     F32_RTOL_LONG if long else F32_RTOL_SMALL)
            glimit = GRAD_F64 if dtype == F64 else GRAD_F32
            nlimit = F64_RTOL if dtype == F64 else NEW_F32
            for dy in orders:
                for naive in (False, True):
                    label = (f"{pname} {name[dtype]} dyadic {dy} "
                             f"{'naive' if naive else 'order-2'}")
                    k1, t1 = synced(lambda: cuda_gen.rbf_gen_solve_final(
                        X, Y, ii, jj, sigma, dy, naive))
                    p1 = cuda_gen.rbf_gen_solve_final_plain(
                        X, Y, ii, jj, sigma, dy, naive)
                    r1 = compare("gen", dtype, k1, p1, limit, "K1 " + label)
                    k2, t2 = synced(lambda: cuda_solver.inc_solve_final(
                        inc, dy, naive))
                    p2 = cuda_solver.inc_solve_final_plain(inc, dy, naive)
                    r2 = compare("inc", dtype, k2, p2, limit, "K2 " + label)
                    check(torch.equal(k2, p2), f"K2 {label}: not bit-equal")
                    torch.cuda.synchronize()
                    print(f"[1] {label}: K1 rel {r1:.2e} ({t1 * 1e3:.1f} ms),"
                          f" K2 rel {r2:.2e} ({t2 * 1e3:.1f} ms), "
                          f"limit {limit:.0e}")
                    k6, t6 = synced(lambda: cuda_lgen.linear_gen_solve_final(
                        X, Y, ii, jj, 0.8, dy, naive))
                    p6 = cuda_lgen.linear_gen_solve_final_plain(
                        X, Y, ii, jj, 0.8, dy, naive)
                    r6 = compare("lgen", dtype, k6, p6, nlimit, "K6 " + label)
                    msg = (f"K6 rel {r6:.2e} (bit-equal {torch.equal(k6, p6)},"
                           f" {t6 * 1e3:.1f} ms)")
                    if not naive:  # the derivative path has no naive scheme
                        grids = deriv_grids(rbf, X, Y, G, ii, jj)
                        k5, t5 = synced(lambda: cuda_deriv.deriv_solve_final(
                            *grids, dy))
                        p5 = cuda_deriv.deriv_solve_final_plain(*grids, dy)
                        del grids
                        r5 = compare("deriv", dtype, k5[0], p5[0], nlimit,
                                     "K5 K " + label)
                        r5d = max(compare_max("deriv", dtype, g, w, nlimit,
                                              f"K5 {n} {label}")
                                  for n, g, w in zip(("K_diff", "K_diffdiff"),
                                                     k5[1:], p5[1:]))
                        eq5 = all(torch.equal(g, w) for g, w in zip(k5, p5))
                        check(eq5, f"K5 {label}: not bit-equal")
                        msg += (f"; K5 K rel {r5:.2e}, K_diff/K_diffdiff max "
                                f"err / max ref {r5d:.2e} (bit-equal {eq5}, "
                                f"{t5 * 1e3:.1f} ms)")
                    torch.cuda.synchronize()
                    print(f"[1] {label}: {msg}, limit {nlimit:.0e}")
                    if M == 1 or N == 1:
                        # no increments: every gradient is exactly 0
                        ct = cuda_gen.rbf_gen_adjoint(X, Y, ii, jj, sigma,
                                                      None, dy, naive)
                        check(ct.shape == (P, 0, N - 1), "length-1 ct shape")
                        x, y = leaf(X, dtype), leaf(Y, dtype)
                        s = torch.tensor(sigma, dtype=dtype, device=dev,
                                         requires_grad=True)
                        skt.sig_gram_lincomb(
                            skt.RBFKernel(s), x, y,
                            torch.ones(P, P, dtype=dtype, device=dev),
                            dyadic_order=dy, naive=naive).backward()
                        check(not (x.grad.any() or y.grad.any()
                                   or s.grad.any()),
                              f"{label}: length-1 gradients are not 0")
                        print(f"[1] {label}: length-1 gradients exactly 0")
                        continue
                    if long and (naive or P == 1):
                        continue  # the adjoint at length 1024: order-2 only
                    v, stk = cuda_gen.rbf_gen_solve_stack(X, Y, ii, jj, sigma,
                                                          dy, naive)
                    pv, pstk = cuda_gen.rbf_gen_solve_stack_plain(
                        X, Y, ii, jj, sigma, dy, naive)
                    check(torch.equal(v, k1), f"K1-stack {label}: values "
                                              "differ from K1's")
                    rs1 = compare_max("gen_stack", dtype, stk, pstk, glimit,
                                      "K1-stack " + label)
                    eq1 = torch.equal(stk, pstk)
                    ct = cuda_gen.rbf_gen_adjoint(X, Y, ii, jj, sigma, stk,
                                                  dy, naive)
                    pct = cuda_gen.rbf_gen_adjoint_plain(X, Y, ii, jj, sigma,
                                                         stk, dy, naive)
                    ra1 = compare_max("adj_gen", dtype, ct, pct, glimit,
                                      "K3<gen> " + label)
                    del stk, pstk
                    got = incvjp.rbf_dd_vjp(X, Y, ii, jj, sigma, ct)
                    want = incvjp.rbf_dd_vjp_plain(X, Y, ii, jj, sigma, ct)
                    rv = max(compare_max("vjp", dtype, g, w, glimit,
                                         f"K4 {label} output {n}")
                             for n, g, w in zip("s X Y".split(), got, want))
                    vjp_bits(X, Y, ii, jj, sigma, ct, "K4 " + label)
                    _, stk2 = cuda_solver.inc_solve_stack(inc, dy, naive)
                    _, pstk2 = cuda_solver.inc_solve_stack_plain(inc, dy,
                                                                 naive)
                    rs2 = compare_max("inc_stack", dtype, stk2, pstk2,
                                      glimit, "K2-stack " + label)
                    eq2 = torch.equal(stk2, pstk2)
                    check(eq2, f"K2-stack {label}: not bit-equal")
                    ct2 = cuda_solver.inc_adjoint(inc, stk2, dy, naive)
                    pct2 = cuda_solver.inc_adjoint_plain(inc, stk2, dy,
                                                         naive)
                    ra2 = compare_max("adj_inc", dtype, ct2, pct2, glimit,
                                      "K3<inc> " + label)
                    del stk2, pstk2
                    torch.cuda.synchronize()
                    print(f"[1] {label}: K1-stack {rs1:.2e} "
                          f"(bit-equal {eq1}), K3<gen> {ra1:.2e}, K4 "
                          f"{rv:.2e}, K2-stack {rs2:.2e} (bit-equal {eq2}), "
                          f"K3<inc> {ra2:.2e}, max err / max ref, limit "
                          f"{glimit:.0e}")
    print(f"[1] all kernel-vs-plain cases passed in "
          f"{time.perf_counter() - t_phase:.1f} s")

    def stripe_kernels(inc, dy, naive, rows, dtype, limit, glimit, label):
        """K7 (forward and flipped), K7-stack and K3<inc, boundary> against
        their plain versions stripe by stripe at stripe height ``rows``,
        bit for bit; the stripe chain against K2 and the striped adjoint
        against K2-stack -> K3<inc> (bit for bit). Returns the bit-equality
        flags."""
        P = inc.shape[0]
        R, C = band.frame(inc.shape[1], inc.shape[2], dy)
        S = -(-R // rows)
        check(S >= 3 and R % rows, f"{label}: {S} stripes, none short")
        bits = []
        bd = inc.new_ones(P, C + 1)
        for row0 in range(0, R, rows):  # the forward chain, last one short
            h = min(rows, R - row0)
            got = cuda_blocked.stripe_solve(inc, bd, row0, h, dy, naive)
            want = cuda_blocked.stripe_solve_plain(inc, bd, row0, h, dy, naive)
            compare("stripe", dtype, got, want, limit, f"K7 {label} {row0}")
            check(torch.equal(got, want), f"K7 {label} {row0}: not bit-equal")
            bits.append(True)
            bd = got
        k2 = cuda_solver.inc_solve_final(inc, dy, naive)
        compare("stripe", dtype, bd[:, C], k2, limit, f"K7 chain {label}")
        bits.append(torch.equal(bd[:, C], k2))
        # the striped adjoint's stripes: every one `rows` tall (zero-padded)
        ones = inc.new_ones(P, C + 1)
        bd_f, bd_r = [ones], [ones]
        for k in range(S - 1):
            for bds, row0, flip in ((bd_f, k * rows, False),
                                    (bd_r, (S - 1 - k) * rows, True)):
                got = cuda_blocked.stripe_solve(inc, bds[-1], row0, rows, dy,
                                                naive, flip)
                want = cuda_blocked.stripe_solve_plain(inc, bds[-1], row0,
                                                       rows, dy, naive, flip)
                compare("stripe", dtype, got, want, limit,
                        f"K7 {label} {row0} flip {flip}")
                check(torch.equal(got, want),
                      f"K7 {label} {row0} flip {flip}: not bit-equal")
                bits.append(True)
                bds.append(got)
        ct, pct = torch.zeros_like(inc), torch.zeros_like(inc)
        for s in range(S):
            b, stk = cuda_blocked.stripe_solve_stack(inc, bd_f[s], s * rows,
                                                     rows, dy, naive)
            pb, pstk = cuda_blocked.stripe_solve_stack_plain(
                inc, bd_f[s], s * rows, rows, dy, naive)
            compare("stripe_stack", dtype, b, pb, limit,
                    f"K7-stack {label} {s} bottom row")
            compare_max("stripe_stack", dtype, stk, pstk, glimit,
                        f"K7-stack {label} {s}")
            check(torch.equal(b, pb) and torch.equal(stk, pstk),
                  f"K7-stack {label} {s}: not bit-equal")
            bits.append(True)
            cuda_blocked.stripe_adjoint(inc, stk, bd_r[S - 1 - s], ct,
                                        s * rows, rows, dy, naive)
            cuda_blocked.stripe_adjoint_plain(inc, stk, bd_r[S - 1 - s], pct,
                                              s * rows, rows, dy, naive)
            del stk, pstk
        compare_max("adj_stripe", dtype, ct, pct, glimit,
                    f"K3<inc, boundary> {label}")
        check(torch.equal(ct, pct), f"K3<inc, boundary> {label}: not "
                                    "bit-equal")
        bits.append(True)
        _, stk = cuda_solver.inc_solve_stack(inc, dy, naive)
        k3 = cuda_solver.inc_adjoint(inc, stk, dy, naive)
        del stk
        got = cuda_blocked.adjoint(inc, dy, naive, rows)
        compare_max("adj_stripe", dtype, got, k3, glimit,
                    f"striped adjoint {label} vs K3<inc>")
        check(torch.equal(got, k3), f"striped adjoint {label}: differs from "
                                    "K3<inc>")
        bits.append(True)
        return bits, k3

    def ckpt_kernels(inc, dy, naive, dtype, limit, glimit, label, k3):
        """K2-sparse against its plain version; K8 against K3<inc>'s
        cotangent ``k3`` (bit for bit: its recompute rounds as the forward
        did) and against its plain version, at the window
        ``cuda_solver.CKPT_WINDOW``."""
        v, sparse = cuda_solver.inc_solve_sparse(inc, dy, naive)
        pv, psparse = cuda_solver.inc_solve_sparse_plain(inc, dy, naive)
        compare("inc_sparse", dtype, v, pv, limit, f"K2-sparse {label}")
        compare_max("inc_sparse", dtype, sparse, psparse, glimit,
                    f"K2-sparse stack {label}")
        bits = [torch.equal(sparse, psparse)]
        check(torch.equal(v, pv) and bits[0], f"K2-sparse {label}: not "
                                              "bit-equal")
        ct = cuda_solver.inc_adjoint_ckpt(inc, sparse, dy, naive)
        pct = cuda_solver.inc_adjoint_ckpt_plain(inc, sparse, dy, naive)
        compare_max("adj_ckpt", dtype, ct, pct, glimit, f"K8 {label}")
        bits.append(torch.equal(ct, pct))
        check(torch.equal(ct, k3), f"K8 {label}: differs from K3<inc>")
        return bits

    t_phase = time.perf_counter()
    window = cuda_solver.CKPT_WINDOW
    for pname, P, M, N, D, orders, hb in STRIPE_PROBLEMS:
        X64 = make_paths(gen, P, M, D, F64)
        Y64 = make_paths(gen, P, N, D, F64)
        ii = torch.arange(P, device=dev)
        jj = ii.flip(0)
        long = max(M, N) >= LONG
        for dtype in (F64, F32):
            X, Y = X64.to(dtype), Y64.to(dtype)
            inc = double_difference(
                skt.RBFKernel(1.0).batch_kernel(X[ii], Y[jj])).contiguous()
            limit = (F64_RTOL if dtype == F64 else
                     F32_RTOL_LONG if long else F32_RTOL_SMALL)
            glimit = GRAD_F64 if dtype == F64 else GRAD_F32
            for dy in orders:
                for naive in (False,) if long else (False, True):
                    label = (f"{pname} {name[dtype]} dyadic {dy} "
                             f"{'naive' if naive else 'order-2'}")
                    rows = hb * 2 ** dy
                    t0 = time.perf_counter()
                    bits, k3 = stripe_kernels(inc, dy, naive, rows, dtype,
                                              limit, glimit, label)
                    for W in CKPT_WINDOWS:
                        cuda_solver.CKPT_WINDOW = W or window
                        bits += ckpt_kernels(
                            inc, dy, naive, dtype, limit, glimit,
                            f"{label} W {cuda_solver.CKPT_WINDOW}", k3)
                    cuda_solver.CKPT_WINDOW = window
                    torch.cuda.synchronize()
                    print(f"[1] {label}, stripes of {rows} rows: K7, "
                          f"K7-stack, K3<inc, boundary>, K2-sparse, K8 within "
                          f"{limit:.0e} / {glimit:.0e}; bit-equal "
                          f"{sum(bits)} of {len(bits)}; K8 equals K3<inc> "
                          f"({time.perf_counter() - t0:.1f} s)")
    print(f"[1] long-path kernel cases passed in "
          f"{time.perf_counter() - t_phase:.1f} s")

    # the band decomposition at its edges: K7, K7-stack and K3<inc,
    # boundary> bit for bit; at dyadic 6 K3<inc, boundary> takes the
    # one-block kernel
    t_phase = time.perf_counter()
    for bname, P, M, N, D, dy, row0, rows, flip, naive in (
            BAND_CASES + [ONE_BLOCK_CASE]):
        X64 = make_paths(gen, P, M, D, F64)
        Y64 = make_paths(gen, P, N, D, F64)
        for dtype in (F64, F32):
            inc = double_difference(skt.RBFKernel(1.0).batch_kernel(
                X64.to(dtype), Y64.to(dtype))).contiguous()
            R, C = band.frame(inc.shape[1], inc.shape[2], dy)
            bd = inc.new_ones(P, C + 1)
            bd[:, 1:] += 1e-2 * torch.rand(P, C, generator=gen, device=dev,
                                           dtype=F64).to(dtype)
            label = (f"{bname} {name[dtype]} (R {R}, C {C}, rows {row0} +"
                     f" {rows}, {-(-rows // band.BAND_ROWS)} bands a "
                     f"pair, flip {flip}, {'naive' if naive else 'order-2'})")
            limit = F64_RTOL if dtype == F64 else F32_RTOL_SMALL
            glimit = GRAD_F64 if dtype == F64 else GRAD_F32
            got, t7 = synced(lambda: cuda_blocked.stripe_solve(
                inc, bd, row0, rows, dy, naive, flip))
            want = cuda_blocked.stripe_solve_plain(inc, bd, row0, rows, dy,
                                                   naive, flip)
            compare("stripe", dtype, got, want, limit, "K7 " + label)
            check(torch.equal(got, want), f"K7 {label}: not bit-equal")
            (b, stk), ts = synced(lambda: cuda_blocked.stripe_solve_stack(
                inc, bd, row0, rows, dy, naive, flip))
            pb, pstk = cuda_blocked.stripe_solve_stack_plain(
                inc, bd, row0, rows, dy, naive, flip)
            compare_max("stripe_stack", dtype, stk, pstk, glimit,
                        f"K7-stack {label}")
            check(torch.equal(b, pb) and torch.equal(stk, pstk),
                  f"K7-stack {label}: not bit-equal")
            del pstk
            if flip:  # K3<inc, boundary> takes the forward stripe's stack
                del stk
                _, stk = cuda_blocked.stripe_solve_stack(inc, bd, row0, rows,
                                                         dy, naive)
            kernel = band.adjoint_kernel(dy)
            key = "one_block" if kernel == "one_block" else name[dtype]
            before = dict(cuda_blocked.ADJOINT_COUNTS)
            ct, ta = synced(lambda: cuda_blocked.stripe_adjoint(
                inc, stk, bd, torch.zeros_like(inc), row0, rows, dy, naive))
            launched = {k: v - before[k]
                        for k, v in cuda_blocked.ADJOINT_COUNTS.items()}
            check(launched == {k: int(k == key) for k in launched},
                  f"K3<inc, boundary> {label}: launches {launched}, not one "
                  f"of the {kernel} kernel")
            pct = cuda_blocked.stripe_adjoint_plain(
                inc, stk, bd, torch.zeros_like(inc), row0, rows, dy, naive)
            compare_max("adj_stripe", dtype, ct, pct, glimit,
                        f"K3<inc, boundary> {label}")
            check(torch.equal(ct, pct),
                  f"K3<inc, boundary> {label}: not bit-equal")
            del stk, inc, ct, pct
            print(f"[1] {label}: K7, K7-stack and K3<inc, boundary> "
                  f"({kernel.replace('_', '-')} kernel) bit-equal to their "
                  f"plain versions ({t7 * 1e3:.1f} / {ts * 1e3:.1f} / "
                  f"{ta * 1e3:.1f} ms)")
    print(f"[1] band cases passed in {time.perf_counter() - t_phase:.1f} s")

    # K1, K1-stack and K3<gen> on the band kernel at its edges, bit for bit;
    # at dyadic 6 K3<gen> takes its one-block kernel
    t_phase = time.perf_counter()
    for gname, P, M, N, D, dy in GEN_BAND_CASES:
        A = max(P // 2, 2)
        X64 = make_paths(gen, A, M, D, F64)
        Y64 = make_paths(gen, A, N, D, F64)
        ii = torch.randint(0, A, (P,), generator=gen, device=dev)
        jj = torch.randint(0, A, (P,), generator=gen, device=dev)
        R = (min(M, N) - 1) * 2 ** dy
        for dtype in (F64, F32):
            X, Y = X64.to(dtype), Y64.to(dtype)
            limit = (F64_RTOL if dtype == F64 else
                     F32_RTOL_LONG if max(M, N) >= LONG else F32_RTOL_SMALL)
            glimit = GRAD_F64 if dtype == F64 else GRAD_F32
            for naive in (False,) if R > 1000 else (False, True):
                label = (f"{gname} {name[dtype]} ({P} pairs, {M} x {N}, D {D},"
                         f" dyadic {dy}, R {R}, "
                         f"{-(-R // band.BAND_ROWS)} bands a pair, "
                         f"{'naive' if naive else 'order-2'})")
                k1, t1 = synced(lambda: cuda_gen.rbf_gen_solve_final(
                    X, Y, ii, jj, 1.0, dy, naive))
                p1 = cuda_gen.rbf_gen_solve_final_plain(X, Y, ii, jj, 1.0, dy,
                                                        naive)
                compare("gen", dtype, k1, p1, limit, "K1 " + label)
                check(torch.equal(k1, p1), f"K1 {label}: not bit-equal")
                (v, stk), ts = synced(lambda: cuda_gen.rbf_gen_solve_stack(
                    X, Y, ii, jj, 1.0, dy, naive))
                pv, pstk = cuda_gen.rbf_gen_solve_stack_plain(
                    X, Y, ii, jj, 1.0, dy, naive)
                compare_max("gen_stack", dtype, stk, pstk, glimit,
                            "K1-stack " + label)
                check(torch.equal(v, k1) and torch.equal(stk, pstk),
                      f"K1-stack {label}: not bit-equal")
                del pstk
                kernel = band.adjoint_kernel(dy)
                key = "one_block" if kernel == "one_block" else name[dtype]
                before = dict(cuda_gen.ADJOINT_COUNTS)
                ct, ta = synced(lambda: cuda_gen.rbf_gen_adjoint(
                    X, Y, ii, jj, 1.0, stk, dy, naive))
                launched = {k: v - before[k]
                            for k, v in cuda_gen.ADJOINT_COUNTS.items()}
                check(launched == {k: int(k == key) for k in launched},
                      f"K3<gen> {label}: launches {launched}, not one of the "
                      f"{kernel} kernel")
                pct = cuda_gen.rbf_gen_adjoint_plain(X, Y, ii, jj, 1.0, stk,
                                                     dy, naive)
                compare_max("adj_gen", dtype, ct, pct, glimit,
                            "K3<gen> " + label)
                check(torch.equal(ct, pct), f"K3<gen> {label}: not bit-equal")
                del stk, ct, pct
                print(f"[1] {label}: K1, K1-stack and K3<gen> "
                      f"({kernel.replace('_', '-')} kernel) bit-equal to "
                      f"their plain versions ({t1 * 1e3:.1f} / "
                      f"{ts * 1e3:.1f} / {ta * 1e3:.1f} ms)")
        torch.cuda.empty_cache()
    print(f"[1] gen band cases passed in "
          f"{time.perf_counter() - t_phase:.1f} s")

    # K5 on the band kernel at its edges, bit for bit
    t_phase = time.perf_counter()
    for dname, P, M, N, D, dy, dnames in DERIV_BAND_CASES:
        A = max(P // 2, 2)
        X64 = make_paths(gen, A, M, D, F64)
        Y64 = make_paths(gen, A, N, D, F64)
        G64 = make_paths(gamma_gen, A, M, D, F64)
        ii = torch.randint(0, A, (P,), generator=gen, device=dev)
        jj = torch.randint(0, A, (P,), generator=gen, device=dev)
        R = (min(M, N) - 1) * 2 ** dy
        for dtype in (getattr(torch, n) for n in dnames):
            grids = deriv_grids(skt.RBFKernel(1.0), X64.to(dtype),
                                Y64.to(dtype), G64.to(dtype), ii, jj)
            nlimit = F64_RTOL if dtype == F64 else NEW_F32
            label = (f"{dname} {name[dtype]} ({P} pairs, {M} x {N}, D {D}, "
                     f"dyadic {dy}, R {R}, "
                     f"{-(-R // band.BAND_ROWS)} bands a pair)")
            k5, t5 = synced(lambda: cuda_deriv.deriv_solve_final(*grids, dy))
            p5 = cuda_deriv.deriv_solve_final_plain(*grids, dy)
            del grids
            compare("deriv", dtype, k5[0], p5[0], nlimit, "K5 K " + label)
            for n, g, w in zip(("K_diff", "K_diffdiff"), k5[1:], p5[1:]):
                compare_max("deriv", dtype, g, w, nlimit, f"K5 {n} {label}")
            check(all(torch.equal(g, w) for g, w in zip(k5, p5)),
                  f"K5 {label}: not bit-equal")
            print(f"[1] {label}: K5 bit-equal to its plain version "
                  f"({t5 * 1e3:.1f} ms)")
        torch.cuda.empty_cache()
    print(f"[1] deriv band cases passed in "
          f"{time.perf_counter() - t_phase:.1f} s")

    # K8 on the band kernel at its edges, bit for bit; at dyadic 6 its
    # one-block kernel
    t_phase = time.perf_counter()
    for cname, P, M, N, D, dy, W in CKPT_BAND_CASES:
        cuda_solver.CKPT_WINDOW = W
        X64 = make_paths(gen, P, M, D, F64)
        Y64 = make_paths(gen, P, N, D, F64)
        R = (min(M, N) - 1) * 2 ** dy
        kernel = cuda_solver.ckpt_kernel(dy, W)
        for dtype in (F64, F32):
            inc = double_difference(skt.RBFKernel(1.0).batch_kernel(
                X64.to(dtype), Y64.to(dtype))).contiguous()
            glimit = GRAD_F64 if dtype == F64 else GRAD_F32
            key = "one_block" if kernel == "one_block" else name[dtype]
            for naive in (False,) if R > 1000 else (False, True):
                label = (f"{cname} {name[dtype]} ({P} pairs, {M} x {N}, "
                         f"dyadic {dy}, R {R}, W {W}, "
                         f"{-(-R // band.BAND_ROWS)} bands a pair, "
                         f"{'naive' if naive else 'order-2'})")
                _, sparse = cuda_solver.inc_solve_sparse(inc, dy, naive)
                before = dict(cuda_solver.CKPT_COUNTS)
                ct, t8 = synced(lambda: cuda_solver.inc_adjoint_ckpt(
                    inc, sparse, dy, naive))
                launched = {k: v - before[k]
                            for k, v in cuda_solver.CKPT_COUNTS.items()}
                check(launched == {k: int(k == key) for k in launched},
                      f"K8 {label}: launches {launched}, not one of the "
                      f"{kernel} kernel")
                pct = cuda_solver.inc_adjoint_ckpt_plain(inc, sparse, dy,
                                                         naive)
                compare_max("adj_ckpt", dtype, ct, pct, glimit,
                            f"K8 {label}")
                check(torch.equal(ct, pct), f"K8 {label}: not bit-equal")
                del sparse, pct
                _, stk = cuda_solver.inc_solve_stack(inc, dy, naive)
                check(torch.equal(ct, cuda_solver.inc_adjoint(
                    inc, stk, dy, naive)),
                      f"K8 {label}: differs from K3<inc>")
                del stk, ct
                print(f"[1] {label}: K8 ({kernel.replace('_', '-')} kernel) "
                      f"bit-equal to its plain version and to K3<inc> "
                      f"({t8 * 1e3:.1f} ms)")
            del inc
        torch.cuda.empty_cache()
    cuda_solver.CKPT_WINDOW = window
    print(f"[1] ckpt band cases passed in "
          f"{time.perf_counter() - t_phase:.1f} s")

    # K2, K2-stack and K2-sparse on the band kernel at its edges, bit for
    # bit against their plain versions and emulations, and run to run
    t_phase = time.perf_counter()
    inc_runs = [
        ("inc", "K2", cuda_solver.inc_solve_final,
         cuda_solver.inc_solve_final_plain,
         cuda_solver.inc_solve_final_banded_plain),
        ("inc_stack", "K2-stack", cuda_solver.inc_solve_stack,
         cuda_solver.inc_solve_stack_plain,
         cuda_solver.inc_solve_stack_banded_plain),
        ("inc_sparse", "K2-sparse", cuda_solver.inc_solve_sparse,
         cuda_solver.inc_solve_sparse_plain,
         cuda_solver.inc_solve_sparse_banded_plain)]
    for iname, P, M, N, D, dy, W, dnames in INC_BAND_CASES:
        cuda_solver.CKPT_WINDOW = W
        X64 = make_paths(gen, P, M, D, F64)
        Y64 = make_paths(gen, P, N, D, F64)
        R = (min(M, N) - 1) * 2 ** dy
        emulate = R <= INC_EMULATE_ROWS
        for dtype in (getattr(torch, n) for n in dnames):
            inc = double_difference(skt.RBFKernel(1.0).batch_kernel(
                X64.to(dtype), Y64.to(dtype))).contiguous()
            limit = (F64_RTOL if dtype == F64 else
                     F32_RTOL_LONG if max(M, N) >= LONG else F32_RTOL_SMALL)
            glimit = GRAD_F64 if dtype == F64 else GRAD_F32
            past = R > _build.max_rows(inc.element_size())
            for naive in (False, True) if emulate else (False,):
                label = (f"{iname} {name[dtype]} ({P} pairs, {M} x {N}, "
                         f"dyadic {dy}, R {R}, W {W}, "
                         f"{-(-R // band.BAND_ROWS)} bands a pair, "
                         f"{'naive' if naive else 'order-2'})")
                ms = []
                emulated = emulate and not naive
                for kind, kname, kern, plain, banded in (
                        inc_runs[:1] if past else inc_runs):
                    got, t = synced(lambda: kern(inc, dy, naive))
                    ms.append(f"{kname} {t * 1e3:.1f} ms")
                    outs = {"plain": plain(inc, dy, naive),
                            "second launch": kern(inc, dy, naive)}
                    if emulated:
                        outs["emulation"] = banded(inc, dy, naive)
                    got = got if isinstance(got, tuple) else (got,)
                    for what, want in outs.items():
                        want = want if isinstance(want, tuple) else (want,)
                        compare(kind, dtype, got[0], want[0], limit,
                                f"{kname} {label} vs its {what}")
                        for g, w in zip(got[1:], want[1:]):
                            compare_max(kind, dtype, g, w, glimit,
                                        f"{kname} {label} stack vs its {what}")
                        check(all(torch.equal(g, w)
                                  for g, w in zip(got, want)),
                              f"{kname} {label}: not bit-equal to its {what}")
                    del got, outs
                said = ("K2 bit-equal to its plain version" if past else
                        "K2, K2-stack and K2-sparse bit-equal to their plain "
                        "versions")
                if emulated:
                    said += ", their emulations"
                print(f"[1] {label}: {said} and a second launch "
                      f"({', '.join(ms)})")
            del inc
        torch.cuda.empty_cache()
    cuda_solver.CKPT_WINDOW = window
    print(f"[1] inc band cases passed in "
          f"{time.perf_counter() - t_phase:.1f} s")

    # K4 at its edges: bit for bit against its emulation, run to run, and
    # against its plain version
    t_phase = time.perf_counter()
    for vname, P, M, N, D, dnames in VJP_CASES:
        X64 = make_paths(gen, 3, M, D, F64)
        Y64 = make_paths(gen, 4, N, D, F64)
        ii = torch.randint(0, 3, (P,), generator=gen, device=dev)
        jj = torch.randint(0, 4, (P,), generator=gen, device=dev)
        H, nb, _ = incvjp.partials(P, M, N, D, 8)
        for dtype in (getattr(torch, n) for n in dnames):
            X, Y = X64.to(dtype), Y64.to(dtype)
            glimit = GRAD_F64 if dtype == F64 else GRAD_F32
            label = (f"{vname} {name[dtype]} ({P} pairs, {M} x {N}, D {D}, "
                     f"{nb} bands of {H} rows)")
            _, stk = cuda_gen.rbf_gen_solve_stack(X, Y, ii, jj, 1.0, 1)
            ct = cuda_gen.rbf_gen_adjoint(X, Y, ii, jj, 1.0, stk, 1)
            del stk
            got, t4 = synced(lambda: incvjp.rbf_dd_vjp(X, Y, ii, jj, 1.0, ct))
            want = incvjp.rbf_dd_vjp_plain(X, Y, ii, jj, 1.0, ct)
            rv = max(compare_max("vjp", dtype, g, w, glimit,
                                 f"K4 {label} output {n}")
                     for n, g, w in zip("s X Y".split(), got, want))
            vjp_bits(X, Y, ii, jj, 1.0, ct, "K4 " + label)
            del got, want, ct
            print(f"[1] {label}: K4 bit-equal to its emulation, two launches "
                  f"identical, {rv:.2e} of max |plain| (limit {glimit:.0e}; "
                  f"{t4 * 1e3:.1f} ms)")
        torch.cuda.empty_cache()
    print(f"[1] vjp cases passed in {time.perf_counter() - t_phase:.1f} s")

    # K9 at the scoring cell's call and its edges: bit for bit against its
    # plain version and a second launch, from counters zeroed just before
    t_phase = time.perf_counter()
    for cname, P, M, N, D in INCREMENT_CASES:
        X64 = make_paths(gen, 32, M, D, F64)
        Y64 = make_paths(gen, 33, N, D, F64)
        ii = torch.randint(0, 32, (P,), generator=gen, device=dev)
        jj = torch.randint(0, 33, (P,), generator=gen, device=dev)
        for dtype in (F64, F32):
            X, Y = X64.to(dtype), Y64.to(dtype)
            limit = F64_RTOL if dtype == F64 else F32_RTOL_LONG
            label = f"K9 {cname} {name[dtype]} ({P} pairs, {M} x {N}, D {D})"
            zero_counters()
            got, t9 = synced(
                lambda: cuda_gen.rbf_gen_increments(X, Y, ii, jj, 0.6))
            again = cuda_gen.rbf_gen_increments(X, Y, ii, jj, 0.6)
            k9n = dict(cuda_gen.INCREMENT_COUNTS)
            check(k9n == {**{n: 0 for n in k9n}, name[dtype]: 2},
                  f"{label}: launches {k9n}, expected two")
            check(torch.equal(again, got), f"{label}: two launches differ")
            del again
            want = cuda_gen.rbf_gen_increments_plain(X, Y, ii, jj, 0.6)
            check(got.shape == (P, M - 1, N - 1) and got.dtype == dtype,
                  f"{label}: shape {tuple(got.shape)}, {got.dtype}")
            compare_bits("incr", dtype, got, want, limit,
                         f"{label} vs its plain version")
            del got, want
            print(f"[1] {label}: K9 bit-equal to its plain version, two "
                  f"launches identical ({t9 * 1e3:.1f} ms)")
        torch.cuda.empty_cache()
    zero_counters()
    print(f"[1] increment cases passed in "
          f"{time.perf_counter() - t_phase:.1f} s")

    # K10 and K11 at the Linear training cell's chunk and their edges: K10
    # bit for bit against its plain version, K11 within LINEAR_VJP of its
    # plain version, both bit for bit against a second launch
    t_phase = time.perf_counter()
    for cname, P, M, N, D in LINEAR_CASES:
        X64 = make_paths(gen, 32, M, D, F64)
        Y64 = make_paths(gen, 33, N, D, F64)
        ii = torch.randint(0, 32, (P,), generator=gen, device=dev)
        jj = torch.randint(0, 33, (P,), generator=gen, device=dev)
        for dtype in (F64, F32):
            a = cuda_lgen.scaled_increments(X64.to(dtype), 0.8)
            b = cuda_lgen.scaled_increments(Y64.to(dtype), 0.8)
            limit = F64_RTOL if dtype == F64 else F32_RTOL_LONG
            label = f"{cname} {name[dtype]} ({P} pairs, {M} x {N}, D {D})"
            zero_counters()
            got, t10 = synced(
                lambda: cuda_lgen.linear_gen_increments(a, b, ii, jj))
            again = cuda_lgen.linear_gen_increments(a, b, ii, jj)
            ct = torch.randn(got.shape, generator=gen, device=dev,
                             dtype=dtype)
            vjp, t11 = synced(
                lambda: cuda_lgen.linear_dd_vjp(a, b, ii, jj, ct))
            vjp2 = cuda_lgen.linear_dd_vjp(a, b, ii, jj, ct)
            for counts, what in ((cuda_lgen.INCREMENT_COUNTS, "K10"),
                                 (cuda_lgen.VJP_COUNTS, "K11")):
                n = dict(counts)
                check(n == {**{k: 0 for k in n}, name[dtype]: 2},
                      f"{what} {label}: launches {n}, expected two")
            check(torch.equal(again, got), f"K10 {label}: two launches "
                                           "differ")
            check(all(torch.equal(u, v) for u, v in zip(vjp, vjp2)),
                  f"K11 {label}: two launches differ")
            del again, vjp2
            want = cuda_lgen.linear_gen_increments_plain(a, b, ii, jj)
            check(got.shape == (P, M - 1, N - 1) and got.dtype == dtype,
                  f"K10 {label}: shape {tuple(got.shape)}, {got.dtype}")
            compare_bits("lincr", dtype, got, want, limit,
                         f"K10 {label} vs its plain version")
            del got, want
            vlimit = LINEAR_VJP[name[dtype]]
            want = cuda_lgen.linear_dd_vjp_plain(a, b, ii, jj, ct)
            rv = max(compare_max("lvjp", dtype, g, w, vlimit,
                                 f"K11 {label} output {n}")
                     for n, g, w in zip("UV", vjp, want))
            del vjp, want, ct
            print(f"[1] {label}: K10 bit-equal to its plain version, K11 "
                  f"{rv:.2e} of max |plain| (limit {vlimit:.0e}), each two "
                  f"launches identical (K10 {t10 * 1e3:.1f} ms, K11 "
                  f"{t11 * 1e3:.1f} ms)")
        torch.cuda.empty_cache()
    zero_counters()
    print(f"[1] Linear increment cases passed in "
          f"{time.perf_counter() - t_phase:.1f} s")

    # ---- phases 2-4: the forward main path, counted ---------------------
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    A, L = NORTH_STAR
    (AL, LL), (AF, LF) = LINEAR, FLOW
    X64 = make_paths(gen, A, L, 3, F64)
    Y64 = make_paths(gen, A, L, 3, F64)
    XL64 = make_paths(gen, AL, LL, 3, F64)
    H64 = make_paths(gen, AF, LF, 3, F64)
    T64 = 1.5 * make_paths(gen, AF, LF, 3, F64)
    rbf = skt.RBFKernel(1.0)
    sig = skt.SigKernel(rbf, dyadic_order=1)

    zero_counters()
    main = {}
    for dtype in (F64, F32):
        X, Y = X64.to(dtype), Y64.to(dtype)
        W = torch.full((A, A), 1.0 / (A * A), dtype=dtype, device=dev)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        calls = [
            ("compute_Gram(X, X, sym=True)", A * (A + 1) // 2,
             lambda: sig.compute_Gram(X, X, sym=True)),
            ("compute_Gram(X, Y)", A * A, lambda: sig.compute_Gram(X, Y)),
            ("compute_mmd(X, Y)", A * (A + 1) + A * A,
             lambda: sig.compute_mmd(X, Y)),
            ("sig_gram_lincomb(X, Y, W, pair_chunk=128)", A * A,
             lambda: skt.sig_gram_lincomb(rbf, X, Y, W, dyadic_order=1,
                                          pair_chunk=128)),
        ]
        for label, pairs, fn in calls:
            out, sec = synced(fn)
            main[(dtype, label)] = out
            print(f"[2] {name[dtype]} {label}: {sec:.3f} s, "
                  f"{pairs / sec:.1f} path-pairs/s ({pairs} pairs)")
        print(f"[2] {name[dtype]} peak memory allocated "
              f"{torch.cuda.max_memory_allocated()} bytes ({base} allocated "
              "before the calls)")

    phase3 = {"linear": skt.LinearKernel(1.0),  # K6
              "rbf_sqr": skt.RBF_SQR_Kernel(1.0, 2.0)}  # K2
    for dtype in (F64, F32):
        XL = XL64.to(dtype)
        for kname, kern in phase3.items():
            sig3 = skt.SigKernel(kern, dyadic_order=0)
            out, sec = synced(lambda: sig3.compute_Gram(XL, XL, sym=True))
            main[(dtype, kname)] = out
            print(f"[3] {name[dtype]} {type(kern).__name__} Gram(sym=True) "
                  f"{AL} x len {LL}: {sec:.3f} s ({AL * (AL + 1) // 2} "
                  "pairs)")

    (rejected, TU, c), sec = synced(lambda: skt.hypothesis_test(
        H64, T64, rbf, dyadic_order=1, verbose=True))
    print(f"[4] hypothesis_test {AF} vs {AF} x len {LF}, dyadic 1: MMD "
          f"{float(TU)}"
          f", threshold {c}, rejected {rejected}, {sec:.3f} s")
    read_counters("2-4", [(k, dt) for k in ("gen", "inc", "lgen")
                          for dt in (F32, F64)])

    # ---- phase 5: the training path at full width, counted --------------
    # (float64 paths, grade) or (float32 paths, grade)
    grades = [("f64 in, grad_solver='f32'", F64, "f32"),
              ("f32 in, grad_solver='auto'", F32, "auto"),
              ("f64 in, grad_solver='auto'", F64, "auto")]
    zero_counters()
    train = {}
    for label, dtype, grade in grades:
        X, Y = leaf(X64, dtype), leaf(Y64, dtype)
        s = torch.tensor(1.0, dtype=dtype, device=dev, requires_grad=True)
        W = torch.full((A, A), 1.0 / (A * A), dtype=dtype, device=dev)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()

        def step():
            S = skt.sig_gram_lincomb(skt.RBFKernel(s), X, Y, W,
                                     dyadic_order=1, pair_chunk=128,
                                     grad_solver=grade)
            S.backward()
            return S.detach()

        S, sec = synced(step)
        peak = torch.cuda.max_memory_allocated()
        train[label] = (S, X.grad, Y.grad, s.grad)
        print(f"[5] {label}: sig_gram_lincomb fwd+bwd {sec:.3f} s, "
              f"{A * A / sec:.1f} path-pairs/s ({A * A} pairs), peak memory "
              f"allocated {peak} bytes ({base} before the call), S "
              f"{float(S)}, dsigma {float(s.grad)}")
    read_counters("5", [("gen", F64), ("gen_stack", F32), ("gen_stack", F64),
                        ("adj_gen", F32), ("adj_gen", F64), ("vjp", F32),
                        ("vjp", F64)])

    # ---- phase 6: the trainer and the inc family's adjoint, counted -----
    zero_counters()
    Y6 = 1.5 * make_paths(gen, AF, LF, 3, F64)
    X6 = make_paths(gen, AF, LF, 3, F64)
    flow = skt.MMDFlow(skt.RBFKernel(1.0), dyadic_order=1)
    (X6_fit, history), sec = synced(lambda: flow.fit(X6, Y6, n_steps=5))
    print(f"[6] MMDFlow.fit {AF} x len {LF} x dim 3, dyadic 1, float64, 5 "
          f"steps: {sec:.3f} s, history {history}")
    lin_grads = {}
    for dtype in (F64, F32):
        XL = leaf(XL64, dtype)
        scale = torch.tensor(1.0, dtype=dtype, device=dev, requires_grad=True)

        def lin_step():
            G = skt.sig_gram(skt.LinearKernel(scale), XL, XL, sym=True)
            G.sum().backward()
            return G

        G, sec = synced(lin_step)
        lin_grads[dtype] = (G.detach(), XL.grad, scale.grad)
        print(f"[6] {name[dtype]} LinearKernel Gram(sym=True) {AL} x len "
              f"{LL} fwd+bwd: {sec:.3f} s ({AL * (AL + 1) // 2} pairs)")
    read_counters("6", [("gen", F64), ("gen_stack", F64), ("adj_gen", F64),
                        ("vjp", F64), ("lgen", F32), ("lgen", F64),
                        ("lincr", F32), ("lincr", F64), ("lvjp", F32),
                        ("lvjp", F64), ("inc_stack", F32),
                        ("inc_stack", F64), ("adj_inc", F32),
                        ("adj_inc", F64)])

    # ---- phase 7: the derivative Gram at the north-star size, counted ---
    zero_counters()
    G64 = make_paths(gen, A, L, 3, F64)
    deriv = {}
    for dtype in (F64, F32):
        X, Y, G = X64.to(dtype), Y64.to(dtype), G64.to(dtype)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out, sec = synced(lambda: sig.compute_kernel_and_derivatives_Gram(
            X, Y, G, max_batch=DERIV_TILE))
        deriv[dtype] = out
        print(f"[7] {name[dtype]} compute_kernel_and_derivatives_Gram(X, Y, "
              f"gamma, max_batch={DERIV_TILE}): {sec:.3f} s, "
              f"{A * A / sec:.1f} path-pairs/s ({A * A} pairs), peak memory "
              f"allocated {torch.cuda.max_memory_allocated()} bytes ({base} "
              "before the call)")
    # one pair past the earlier one-block K5's bound: K5's band kernel
    L7, dy7 = DERIV_LONG
    X7, Y7, G7 = (make_paths(gen, 1, L7, 3, F64) for _ in range(3))
    k5 = cuda_deriv.COUNTS["float64"]
    deriv_long, sec = synced(lambda: skt.sig_kernel_and_derivatives_gram(
        rbf, X7, Y7, G7, dyadic_order=dy7))
    check(cuda_deriv.COUNTS["float64"] == k5 + 1,
          "[7] the long pair did not take one K5 launch")
    print(f"[7] float64 one pair, len {L7}, dyadic {dy7} ({(L7 - 1) * 2 ** dy7}"
          f" refined rows; the one-block K5 held 4,840), solver='auto': "
          f"{sec:.3f} s, one K5 launch ({card})")
    read_counters("7", [("deriv", F32), ("deriv", F64)])

    # ---- phase 8: CHSIC at the long-path stress size, counted -----------
    zero_counters()
    m8, L8, D8, dy8 = CHSIC
    XYZ = [make_paths(gen, m8, L8, D8, F64) for _ in range(3)]
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    chsic, sec = synced(lambda: skt.sig_chsic(*XYZ, skt.RBFKernel(1.0),
                                              dyadic_order=dy8))
    pairs8 = 3 * m8 * (m8 + 1) // 2
    print(f"[8] float64 sig_chsic m {m8} x len {L8} x dim {D8}, dyadic {dy8}:"
          f" {float(chsic)}, {sec:.3f} s, {pairs8 / sec:.1f} path-pairs/s "
          f"({pairs8} pairs in three sym Grams), peak memory allocated "
          f"{torch.cuda.max_memory_allocated()} bytes ({base} before the "
          "call)")
    read_counters("8", [("gen", F64)])

    # ---- phase 9: the Linear Gram at the north-star size, counted -------
    zero_counters()
    lin9 = skt.SigKernel(skt.LinearKernel(1.0), dyadic_order=1)
    linear9 = {}
    for dtype in (F64, F32):
        X, Y = X64.to(dtype), Y64.to(dtype)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out, sec = synced(lambda: lin9.compute_Gram(X, Y))
        linear9[dtype] = (out, sec)
        print(f"[9] {name[dtype]} LinearKernel compute_Gram(X, Y): {sec:.3f}"
              f" s, {A * A / sec:.1f} path-pairs/s ({A * A} pairs), peak "
              f"memory allocated {torch.cuda.max_memory_allocated()} bytes "
              f"({base} before the call)")
    launched = cuda_lgen.COUNTS["float32"] + cuda_lgen.COUNTS["float64"]
    read_counters("9", [("lgen", F32), ("lgen", F64)])
    check(launched == 2, f"[9] {launched} K6 launches, expected one per dtype")
    # phases 2-9 keep their routes: none reached the long-path tier
    check(not any(launches[(k, dt)] for k in long_kinds for dt in (F32, F64)),
          "phases 2-9 launched a long-path kernel")

    # ---- checks of phases 2-6 against plain versions --------------------
    pick = torch.Generator(device="cpu").manual_seed(2)
    ii = torch.randint(0, A, (4,), generator=pick).to(dev)
    jj = torch.randint(0, A, (4,), generator=pick).to(dev)
    for dtype in (F64, F32):
        limit = F64_RTOL if dtype == F64 else F32_RTOL_LONG
        X, Y = X64.to(dtype), Y64.to(dtype)
        G_sym = main[(dtype, "compute_Gram(X, X, sym=True)")]
        G_xy = main[(dtype, "compute_Gram(X, Y)")]
        for label, out in ((k[1], v) for k, v in main.items()
                           if k[0] == dtype):
            check(bool(torch.isfinite(out).all()), f"{label}: non-finite")
        check(G_sym.shape == (A, A) and G_xy.shape == (A, A), "Gram shapes")
        check(torch.equal(G_sym, G_sym.T), "sym Gram is not exactly symmetric")
        for Yv, G, what in ((Y, G_xy, "Gram(X, Y)"), (X, G_sym, "Gram(X, X)")):
            label = f"{name[dtype]} {what} 4 random pairs"
            want = cuda_gen.rbf_gen_solve_final_plain(X, Yv, ii, jj, 1.0, 1)
            r = compare("gen", dtype, G[ii, jj], want, limit, label)
            print(f"[2] {label} vs plain version: rel {r:.2e} "
                  f"(limit {limit:.0e})")
        lin_v = main[(dtype, "sig_gram_lincomb(X, Y, W, pair_chunk=128)")]
        r = abs(float(lin_v - G_xy.mean())) / abs(float(G_xy.mean()))
        check(r <= (1e-12 if dtype == F64 else 1e-5),
              f"lincomb vs Gram mean rel {r:.2e}")
        print(f"[2] {name[dtype]} lincomb vs mean of Gram(X, Y): rel "
              f"{r:.2e}")
    g32 = main[(F32, "compute_Gram(X, Y)")].double()
    g64 = main[(F64, "compute_Gram(X, Y)")]
    r = float((g32 - g64).abs().max() / g64.abs().max())
    check(r <= F32_VS_F64, f"f32 Gram vs f64 Gram {r:.2e}")
    print(f"[2] float32 Gram(X, Y) vs float64 Gram(X, Y): max abs err / max "
          f"|K| {r:.2e} (limit {F32_VS_F64:.0e}); max rel err "
          f"{rel_err(g32, g64):.2e}; |K| in [{float(g64.abs().min()):.3g}, "
          f"{float(g64.abs().max()):.3g}]")

    iu, ju = torch.triu_indices(AL, AL, device=dev)
    for dtype in (F64, F32):
        XL = XL64.to(dtype)
        # the Linear Gram against the plain version of its route (K6's): in
        # float32 the grid route's double difference cancels, so a float32
        # bar against it would measure the grid's error, not K6's
        want = cuda_lgen.linear_gen_solve_final_plain(XL, XL, iu, ju, 1.0, 0)
        limit = F64_RTOL if dtype == F64 else NEW_F32
        r = compare("lgen", dtype, main[(dtype, "linear")][iu, ju], want,
                    limit, f"{name[dtype]} LinearKernel Gram vs plain K6")
        print(f"[3] {name[dtype]} LinearKernel Gram vs K6's plain version: "
              f"rel {r:.2e} (limit {limit:.0e})")
        want = skt.sig_gram(phase3["rbf_sqr"], XL, XL, sym=True,
                            solver="scan")
        limit = F64_RTOL if dtype == F64 else F32_RTOL_SMALL
        r = compare("inc", dtype, main[(dtype, "rbf_sqr")], want, limit,
                    f"{name[dtype]} RBF_SQR_Kernel Gram vs plain tier")
        print(f"[3] {name[dtype]} RBF_SQR_Kernel Gram vs plain tier: rel "
              f"{r:.2e} (limit {limit:.0e})")
    r = max_rel(main[(F32, "linear")].double(), main[(F64, "linear")])
    print(f"[3] float32 LinearKernel Gram vs float64: max abs err / max |K| "
          f"{r:.2e}")

    TU_plain = skt.sig_mmd(rbf, H64, T64, dyadic_order=1, solver="scan")
    err = abs(float(TU) - float(TU_plain))
    check(err <= F64_RTOL * max(1.0, abs(float(TU_plain))),
          f"hypothesis_test MMD vs plain tier abs err {err:.2e}")
    print(f"[4] hypothesis_test MMD vs plain tier: abs err {err:.2e}")

    # phase 5: values equal to the forward-only lincomb of phase 2 (the
    # same sweeps, summed in the same order), gradients finite
    lin_key = "sig_gram_lincomb(X, Y, W, pair_chunk=128)"
    for label, dtype, grade in grades:
        S, gX, gY, gs = train[label]
        for t in (gX, gY, gs):
            check(t is not None and bool(torch.isfinite(t).all())
                  and t.dtype == dtype, f"[5] {label}: gradient")
        check(bool(gX.abs().max() > 0) and bool(gs.abs() > 0),
              f"[5] {label}: zero gradient")
        check(torch.equal(S, main[(dtype, lin_key)]),
              f"[5] {label}: value {float(S)} differs from the forward-only "
              f"lincomb {float(main[(dtype, lin_key)])}")
        print(f"[5] {label}: value equals the forward-only lincomb")
    a = train["f64 in, grad_solver='auto'"]
    b = train["f64 in, grad_solver='f32'"]
    print("[5] float64 paths, grad_solver='f32' against the float64 grade "
          "(max |diff| / max |f64 grade|): dX "
          f"{max_rel(b[1], a[1]):.3e}, dY {max_rel(b[2], a[2]):.3e}, dsigma "
          f"{max_rel(b[3], a[3]):.3e} (not gated; the JAX package measured "
          "2.69e-2 on a TPU at this grid)")
    # the 2 x 2 sub-problem at length 1024 against the plain tier (float64)
    ref = {}
    for solver in ("scan", "auto"):
        for label, dtype, grade in grades:
            if solver == "scan" and label != grades[2][0]:
                continue
            x, y = leaf(X64[:2], dtype), leaf(Y64[:2], dtype)
            s = torch.tensor(1.0, dtype=dtype, device=dev,
                             requires_grad=True)
            W = torch.full((2, 2), 0.25, dtype=dtype, device=dev)
            skt.sig_gram_lincomb(skt.RBFKernel(s), x, y, W, dyadic_order=1,
                                 solver=solver,
                                 grad_solver=grade).backward()
            ref[(solver, label)] = (x.grad.double(), y.grad.double(),
                                    s.grad.double())
    want = ref[("scan", grades[2][0])]
    for label, dtype, grade in grades:
        got = ref[("auto", label)]
        bar = CHAIN_F64 if (dtype == F64 and grade == "auto") else CHAIN_F32
        errs = [max_rel(g, w) for g, w in zip(got, want)]
        print(f"[5] 2 x 2 pairs, len {L}, {label} vs solver='scan' (float64"
              f" plain adjoint): dX {errs[0]:.3e}, dY {errs[1]:.3e}, dsigma "
              f"{errs[2]:.3e} (limit {bar:.1e})")
        check(max(errs) <= bar, f"[5] {label}: 2 x 2 gradients vs plain tier")

    check(all(math.isfinite(h) for h in history) and len(history) == 5,
          f"[6] MMDFlow history {history}")
    check(history[-1] < history[0], f"[6] MMDFlow MMD did not fall: "
                                    f"{history}")
    check(bool(torch.isfinite(X6_fit).all()), "[6] MMDFlow particles")
    for dtype in (F64, F32):
        XL = leaf(XL64, dtype)
        scale = torch.tensor(1.0, dtype=dtype, device=dev, requires_grad=True)
        G = skt.sig_gram(skt.LinearKernel(scale), XL, XL, sym=True,
                         solver="scan")
        G.sum().backward()
        bar = GRAD_F64 if dtype == F64 else GRAD_F32
        got = lin_grads[dtype]
        errs = [max_rel(got[1], XL.grad), max_rel(got[2], scale.grad)]
        print(f"[6] {name[dtype]} LinearKernel Gram backward vs plain tier: "
              f"dX {errs[0]:.3e}, dscale {errs[1]:.3e} (limit {bar:.0e}); "
              f"dX max abs err {float((got[1] - XL.grad).abs().max()):.3e}")
        check(max(errs) <= bar, f"[6] {name[dtype]} LinearKernel gradients")

    # phase 7: shapes and dtypes; a 4 x 4 sub-problem against the plain
    # tier (the triple sweep in torch on the same card)
    for dtype in (F64, F32):
        X, Y, G = X64.to(dtype), Y64.to(dtype), G64.to(dtype)
        for t in deriv[dtype]:
            check(t.shape == (A, A) and t.dtype == dtype
                  and bool(torch.isfinite(t).all()), "[7] derivative Gram")
        want = skt.sig_kernel_and_derivatives_gram(
            rbf, X[:4], Y[:4], G[:4], dyadic_order=1, solver="scan")
        got = [t[:4, :4] for t in deriv[dtype]]
        kbar = F64_RTOL if dtype == F64 else F32_RTOL_LONG
        dbar = DERIV_F64 if dtype == F64 else DERIV_F32
        errs = [rel_err(got[0], want[0]), max_rel(got[1], want[1]),
                max_rel(got[2], want[2])]
        print(f"[7] {name[dtype]} 4 x 4 sub-problem vs solver='scan': K rel "
              f"{errs[0]:.2e} (limit {kbar:.0e}), K_diff {errs[1]:.2e}, "
              f"K_diffdiff {errs[2]:.2e} max err / max ref (limit "
              f"{dbar:.0e})")
        check(errs[0] <= kbar and max(errs[1:]) <= dbar,
              f"[7] {name[dtype]} derivative Gram vs plain tier")
    want, sec = synced(lambda: skt.sig_kernel_and_derivatives_gram(
        rbf, X7, Y7, G7, dyadic_order=dy7, solver="scan"))
    errs = [rel_err(deriv_long[0], want[0]), max_rel(deriv_long[1], want[1]),
            max_rel(deriv_long[2], want[2])]
    for got in deriv_long:
        check(got.shape == (1, 1) and bool(torch.isfinite(got).all()),
              "[7] the long pair: shape or non-finite")
    check(max(errs) <= DERIV_F64, "[7] the long pair differs from "
                                  "solver='scan'")
    print(f"[7] the long pair on K5 vs solver='scan' ({sec:.3f} s): K rel "
          f"{errs[0]:.2e}, K_diff {errs[1]:.2e}, K_diffdiff {errs[2]:.2e} "
          f"(limit {DERIV_F64:.0e}; bit-equal "
          f"{all(torch.equal(g, w) for g, w in zip(deriv_long, want))}): K "
          f"{float(deriv_long[0])}, K_diff {float(deriv_long[1])}, "
          f"K_diffdiff {float(deriv_long[2])}")
    del X7, Y7, G7, deriv_long, want
    errs = [max_rel(a.double(), b) for a, b in zip(deriv[F32], deriv[F64])]
    print("[7] float32 vs float64 derivative Gram, max abs err / max |ref|: "
          f"K {errs[0]:.2e}, K_diff {errs[1]:.2e}, K_diffdiff {errs[2]:.2e}")
    check(errs[0] <= F32_VS_F64, "[7] float32 K vs float64 K")

    # phase 8: a finite scalar; on a small input the statistic and its
    # Grams against the plain tier on the card (the Grams by
    # solver="scan"), so both sides share the statistic's linear algebra:
    # against CPU tensors its Cholesky solve and three-term cancellation
    # turned the two devices' last-bit differences into 1.8e-13 in one run
    # and 4.9e-10 in another on the same inputs
    check(chsic.shape == () and bool(torch.isfinite(chsic)), "[8] CHSIC")
    small = [t[:8, :64] for t in XYZ]
    rbf8 = skt.RBFKernel(1.0)
    gram = stats.sig_gram
    rg = max(rel_err(gram(rbf8, t, t, dyadic_order=dy8, sym=True),
                     gram(rbf8, t, t, dyadic_order=dy8, sym=True,
                          solver="scan")) for t in small)
    got = float(skt.sig_chsic(*small, rbf8, dyadic_order=dy8))
    stats.sig_gram = lambda *args, **kw: gram(*args, solver="scan", **kw)
    want = float(skt.sig_chsic(*small, rbf8, dyadic_order=dy8))
    stats.sig_gram = gram
    r = abs(got - want) / abs(want)
    print(f"[8] sig_chsic 8 x len 64 on the card vs the plain tier there: "
          f"Grams rel {rg:.2e}, statistic rel {r:.2e} (limit "
          f"{F64_RTOL:.0e})")
    check(rg <= F64_RTOL and r <= F64_RTOL, "[8] CHSIC vs plain tier")

    # phase 9: 4 random pairs against K6's plain version; float32 against
    # float64; then the route K6 replaces, timed in turns with K6
    for dtype in (F64, F32):
        X, Y = X64.to(dtype), Y64.to(dtype)
        K = linear9[dtype][0]
        check(K.shape == (A, A) and bool(torch.isfinite(K).all()),
              "[9] Linear Gram")
        want = cuda_lgen.linear_gen_solve_final_plain(X, Y, ii, jj, 1.0, 1)
        limit = F64_RTOL if dtype == F64 else NEW_F32
        r = compare("lgen", dtype, K[ii, jj], want, limit,
                    f"[9] {name[dtype]} Linear Gram vs plain K6")
        print(f"[9] {name[dtype]} Linear Gram 4 random pairs vs K6's plain "
              f"version: rel {r:.2e} (limit {limit:.0e})")
    K64 = linear9[F64][0]
    r = max_rel(linear9[F32][0].double(), K64)
    print(f"[9] float32 K6 Linear Gram vs float64 K6: max abs err / max |K| "
          f"{r:.2e}; |K| in [{float(K64.abs().min()):.3g}, "
          f"{float(K64.abs().max()):.3g}]")
    check(r <= F32_VS_F64, "[9] float32 Linear Gram vs float64")

    class GridLinear(skt.LinearKernel):
        """Not exactly LinearKernel: takes the inc family, the torch-built
        increment grid and K2, as LinearKernel did before K6."""

    for dtype in (F64, F32):
        X, Y = X64.to(dtype), Y64.to(dtype)
        runs = {"K6": [linear9[dtype][1]], "grid": []}
        for route in ("grid", "K6", "grid"):
            kern = GridLinear(1.0) if route == "grid" else skt.LinearKernel(1.0)
            out, sec = synced(lambda: skt.sig_gram(
                kern, X, Y, dyadic_order=1,
                max_batch=GRID_TILE if route == "grid" else 100))
            runs[route].append(sec)
            if route == "grid":
                grid_K = out
            del out
        r = max_rel(grid_K.double(), K64)
        print(f"[9] {name[dtype]} Linear Gram: K6 {runs['K6']} s, grid route "
              f"(K2, max_batch={GRID_TILE}) {runs['grid']} s, "
              f"{A * A / min(runs['K6']):.1f} against "
              f"{A * A / min(runs['grid']):.1f} path-pairs/s; grid route vs "
              f"float64 K6 max abs err / max |K| {r:.2e} ({card})")
        del grid_K
        torch.cuda.empty_cache()

    # ---- phase 10: long paths, forward, counted -------------------------
    L10, D10, dy10 = LONG_PATHS
    side = (L10 - 1) * 2 ** dy10  # the refined grid's side
    n_gram, n_mmd, mb10, n_check = LONG_FWD
    XL = make_paths(gen, n_gram, L10, D10, F64)
    YL = make_paths(gen, n_mmd, L10, D10, F64)
    not_gen = [(k, dt) for k in ("gen", "gen_stack", "lgen")
               for dt in (F32, F64)]
    zero_counters()
    long_fwd = {}
    for dtype in (F64, F32):
        X, Y = XL.to(dtype), YL.to(dtype)
        calls = [
            (f"sig_gram(X, X, sym=True), {n_gram} paths",
             n_gram * (n_gram + 1) // 2,
             lambda: skt.sig_gram(rbf, X, X, dyadic_order=dy10, sym=True,
                                  max_batch=mb10)),
            (f"sig_mmd(X, Y), {n_mmd} vs {n_mmd} paths",
             n_mmd * (n_mmd + 1) + n_mmd * n_mmd,
             lambda: skt.sig_mmd(rbf, X[:n_mmd], Y, dyadic_order=dy10,
                                 max_batch=mb10))]
        for label, pairs, fn in calls:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            out, sec = synced(fn)
            long_fwd[(dtype, label)] = out
            print(f"[10] {name[dtype]} {label}, len {L10}, dim {D10}, dyadic "
                  f"{dy10}, max_batch {mb10}: {sec:.3f} s, "
                  f"{pairs / sec:.3f} path-pairs/s ({pairs} pairs, stripes "
                  f"of {cuda_blocked.stripe_rows(dy10, X.element_size())} "
                  f"rows), peak memory allocated "
                  f"{torch.cuda.max_memory_allocated()} bytes ({base} before "
                  "the call)")
    read_counters("10", [("stripe", F32), ("stripe", F64)], not_gen)
    gram_label = calls[0][0]
    pick = torch.tensor([[0, 1], [n_gram - 1, 2]], device=dev)[:, :n_check]
    for dtype in (F64, F32):
        G = long_fwd[(dtype, gram_label)]
        check(G.shape == (n_gram, n_gram) and bool(torch.isfinite(G).all())
              and torch.equal(G, G.T), f"[10] {name[dtype]} Gram")
        mmd = long_fwd[(dtype, calls[1][0])]
        check(mmd.shape == () and bool(torch.isfinite(mmd)), "[10] MMD")
        X = XL.to(dtype)
        inc = double_difference(rbf.batch_kernel(X[pick[0]], X[pick[1]]))
        want = cuda_blocked.solve_final_plain(inc.contiguous(), dy10)
        del inc
        limit = F64_RTOL if dtype == F64 else F32_RTOL_LONG
        r = compare("stripe", dtype, G[pick[0], pick[1]], want, limit,
                    f"[10] {name[dtype]} {n_check} pairs vs plain stripes")
        print(f"[10] {name[dtype]} {n_check} Gram pairs vs the plain stripes:"
              f" rel {r:.2e} (limit {limit:.0e}, bit-equal "
              f"{torch.equal(G[pick[0], pick[1]], want)}); MMD {float(mmd)}")
    r = max_rel(long_fwd[(F32, gram_label)].double(),
                long_fwd[(F64, gram_label)])
    print(f"[10] float32 vs float64 Gram at a {side:,}^2 grid: max abs err "
          f"/ max |K| {r:.2e}")
    torch.cuda.empty_cache()

    # ---- phase 11: long paths, training, counted ------------------------
    mb11, pc11 = LONG_TRAIN
    long_grades = [("f64 in, grad_solver='auto'", "auto"),
                   ("f64 in, grad_solver='f32'", "f32")]
    zero_counters()
    long_train = {}
    for label, grade in long_grades:
        X, Y = leaf(XL[:n_mmd], F64), leaf(YL, F64)
        s = torch.tensor(1.0, dtype=F64, device=dev, requires_grad=True)

        def step():
            v = skt.sig_mmd(skt.RBFKernel(s), X, Y, dyadic_order=dy10,
                            max_batch=mb11, pair_chunk=pc11,
                            grad_solver=grade)
            v.backward()
            return v.detach()

        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        v, sec = synced(step)
        pairs = n_mmd * (n_mmd + 1) + n_mmd * n_mmd
        long_train[label] = (v, X.grad, Y.grad, s.grad)
        rows = cuda_blocked.adjoint_rows(dy10, 8 if grade == "auto" else 4)
        print(f"[11] {label}: sig_mmd {n_mmd} vs {n_mmd} x len {L10}, "
              f"max_batch {mb11}, pair_chunk {pc11}, fwd+bwd {sec:.3f} s, "
              f"{pairs / sec:.3f} path-pairs/s ({pairs} pairs; adjoint "
              f"stripes of {rows} rows), peak memory allocated "
              f"{torch.cuda.max_memory_allocated()} bytes ({base} before "
              f"the call), MMD {float(v)}, dsigma {float(s.grad)}")
    read_counters("11", [(k, dt) for k in ("stripe", "stripe_stack",
                                           "adj_stripe", "incr", "vjp")
                         for dt in (F32, F64)], not_gen)
    check(cuda_blocked.ADJOINT_COUNTS["one_block"] == 0,
          "[11] K3<inc, boundary> took the one-block kernel")
    v64 = long_fwd[(F64, calls[1][0])]
    K_max = float(long_fwd[(F64, gram_label)].abs().max())
    for label, grade in long_grades:
        v, gX, gY, gs = long_train[label]
        for t in (gX, gY, gs):
            check(t is not None and bool(torch.isfinite(t).all())
                  and t.dtype == F64, f"[11] {label}: gradient")
        check(bool(gX.abs().max() > 0) and bool(gs.abs() > 0),
              f"[11] {label}: zero gradient")
        err = abs(float(v) - float(v64))
        check(err <= F64_RTOL * K_max, f"[11] {label}: lincomb MMD {float(v)}"
                                       f" vs phase 10's {float(v64)}")
        print(f"[11] {label}: MMD vs phase 10's Gram route abs err {err:.2e}"
              f" (limit {F64_RTOL:.0e} x max |K|)")
    a, b = (long_train[label] for label, _ in long_grades)
    print(f"[11] grad_solver='f32' against the float64 grade at a {side:,}^2 "
          f"grid (max |diff| / max |f64 grade|): dX {max_rel(b[1], a[1]):.3e},"
          f" dY {max_rel(b[2], a[2]):.3e}, dsigma {max_rel(b[3], a[3]):.3e} "
          "(not gated)")
    del long_fwd, long_train, a, b
    torch.cuda.empty_cache()
    # a sub-problem through the same routes at a forced row bound, against
    # the plain tier on the card
    L_sub, bound_rows = LONG_SUB
    saved_rows = _build.max_rows
    _build.max_rows = lambda itemsize: bound_rows
    before = cuda_blocked.ADJOINT_COUNTS["float64"]
    sub = {}
    for solver, grade in (("scan", "auto"), ("auto", "auto"),
                          ("auto", "f32")):
        x, y = leaf(XL[:2, :L_sub], F64), leaf(YL[:2, :L_sub], F64)
        s = torch.tensor(1.0, dtype=F64, device=dev, requires_grad=True)
        skt.sig_mmd(skt.RBFKernel(s), x, y, dyadic_order=dy10, max_batch=1,
                    pair_chunk=2, solver=solver,
                    grad_solver=grade).backward()
        sub[(solver, grade)] = (x.grad, y.grad, s.grad)
    _build.max_rows = saved_rows
    check(cuda_blocked.ADJOINT_COUNTS["float64"] > before,
          "[11] the sub-problem did not take the striped adjoint")
    for grade, bar in (("auto", CHAIN_F64), ("f32", CHAIN_F32)):
        errs = [max_rel(g, w) for g, w in zip(sub[("auto", grade)],
                                              sub[("scan", "auto")])]
        print(f"[11] 2 x 2 pairs, len {L_sub}, dyadic {dy10}, stripes of "
              f"{bound_rows} rows, grade {grade} vs solver='scan': dX "
              f"{errs[0]:.3e}, dY {errs[1]:.3e}, dsigma {errs[2]:.3e} "
              f"(limit {bar:.1e})")
        check(max(errs) <= bar, f"[11] grade {grade}: sub-problem gradients")

    # ---- phase 12: the sparse-checkpoint adjoint, counted ---------------
    n12, L12, D12, dy12 = CKPT
    n12f, L12f = CKPT_F32
    X12 = make_paths(gen, n12, L12, D12, F64)
    y12 = make_paths(gen, 1, L12, D12, F64)
    X12f = make_paths(gen, n12f, L12f, D12, F32)
    y12f = make_paths(gen, 1, L12f, D12, F32)

    class GridRBF(skt.RBFKernel):
        """Not exactly RBFKernel: takes the inc family (K2, K2-stack ->
        K3<inc>) where RBFKernel would take the generator."""

    def score(kern_cls, X, y):
        x = leaf(X, X.dtype)
        s = torch.tensor(1.0, dtype=X.dtype, device=dev, requires_grad=True)

        def run():
            v = skt.sig_scoring_rule(kern_cls(s), x, y, dyadic_order=dy12)
            v.backward()
            return v.detach()

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        v, sec = synced(run)
        peak = torch.cuda.max_memory_allocated()
        return (v, x.grad, s.grad), sec, peak, base

    def npairs(n):
        return n * (n + 1) // 2 + n

    pairs12 = npairs(n12)
    R12 = (L12 - 1) * 2 ** dy12
    fam12 = routes.resolve_family(skt.RBFKernel(1.0), "cuda", "auto",
                                  shape=(R12, R12), need_grad=True)
    inc12 = routes.resolve_inc_tier((R12, R12), 8, backward=True)
    saved_pairs = set_gates(routes, SPARSE_GATE)
    print(f"[12] the gates (CKPT_MIN_PAIRS, GEN_CKPT_MIN_PAIRS = "
          f"{saved_pairs}) take RBFKernel to the {fam12} family and the inc "
          f"family to its {inc12} tier at this size; the counted runs patch "
          f"both to the sparse route")
    zero_counters()
    (out12, sec, peak, base) = score(skt.RBFKernel, X12, y12)
    print(f"[12] float64 sig_scoring_rule X {n12} x len {L12} x dim {D12}, "
          f"y 1, dyadic {dy12}, fwd+bwd on the sparse route: {sec:.3f} s, "
          f"{pairs12 / sec:.3f} path-pairs/s ({pairs12} pairs), peak memory "
          f"allocated {peak} bytes ({base} before the call)")
    (out12f, secf, peakf, basef) = score(skt.RBFKernel, X12f, y12f)
    pairs12f = npairs(n12f)
    print(f"[12] float32 sig_scoring_rule X {n12f} x len {L12f}, y 1, dyadic "
          f"{dy12}, fwd+bwd on the sparse route: {secf:.3f} s, "
          f"{pairs12f / secf:.3f} path-pairs/s ({pairs12f} pairs), peak "
          f"memory allocated {peakf} bytes ({basef} before the call)")
    # the default max_batch's whole tile: 5,050 pairs in one sym Gram tile
    X12w = make_paths(gen, CKPT_WIDE, L12, D12, F64)
    (out12w, secw, peakw, basew) = score(skt.RBFKernel, X12w, y12)
    print(f"[12] float64 sig_scoring_rule X {CKPT_WIDE} (max_batch 100: one "
          f"{CKPT_WIDE * (CKPT_WIDE + 1) // 2}-pair tile), fwd+bwd on the "
          f"sparse route: {secw:.3f} s, {npairs(CKPT_WIDE) / secw:.3f} "
          f"path-pairs/s ({npairs(CKPT_WIDE)} pairs), peak memory allocated "
          f"{peakw} bytes ({basew} before the call) ({card})")
    del X12w
    set_gates(routes, saved_pairs)
    read_counters("12", [(k, dt) for k in ("inc", "inc_sparse", "adj_ckpt",
                                           "incr", "vjp")
                         for dt in (F32, F64)],
                  [(k, dt) for k in ("gen_stack", "inc_stack", "adj_gen",
                                     "adj_inc") for dt in (F32, F64)])
    for out, dtype in ((out12, F64), (out12f, F32), (out12w, F64)):
        for t in out:
            check(bool(torch.isfinite(t).all()) and t.dtype == dtype,
                  f"[12] {name[dtype]}: non-finite")
        check(bool(out[1].abs().max() > 0) and bool(out[2].abs() > 0),
              f"[12] {name[dtype]}: zero gradient")
    del out12w
    # the same float64 call on the full-stack routes (the gates' pair counts
    # set to 1), in turns with the sparse route; uncounted
    routes12 = {"sparse (K2-sparse -> K8)": (skt.RBFKernel, SPARSE_GATE,
                                             cuda_solver.CKPT_COUNTS),
                "full, generator (K1-stack -> K3<gen> -> K4)":
                    (skt.RBFKernel, 1, cuda_gen.ADJOINT_COUNTS),
                "full, increment grid (K2-stack -> K3<inc>)":
                    (GridRBF, 1, cuda_solver.ADJOINT_COUNTS)}
    order = list(routes12) + [next(iter(routes12))]
    res12 = {}
    for route in order:
        kern_cls, pairs, counts = routes12[route]
        set_gates(routes, pairs)
        before = counts["float64"]
        out, sec, peak, base = score(kern_cls, X12, y12)
        check(counts["float64"] > before, f"[12] {route}: not taken")
        res12[route] = out
        print(f"[12] float64 {route}: {sec:.3f} s, {pairs12 / sec:.3f} "
              f"path-pairs/s, peak memory allocated {peak} bytes ({base} "
              f"before the call) ({card})")
    set_gates(routes, saved_pairs)
    for route, out in res12.items():
        errs = [max_rel(g, w) for g, w in zip(out[1:], out12[1:])]
        print(f"[12] {route} vs the counted sparse run: value rel "
              f"{abs(float(out[0] - out12[0])) / abs(float(out12[0])):.2e}, "
              f"dX {errs[0]:.3e}, dsigma {errs[1]:.3e} (limit "
              f"{CHAIN_F64:.0e})")
        check(max(errs) <= CHAIN_F64, f"[12] {route}: gradients")
    del res12, out12, out12f
    torch.cuda.empty_cache()

    # the ckpt gate's crossover; uncounted
    gate_sweep(gen, card, X64, Y64, GridRBF)

    # ---- kernel times beside their plain versions -----------------------
    timing = {}

    def timed(kind, dtype, kern, plain, cmp, lim, shape, where, tag=None,
              library=None):
        """Time ``plain`` (its one call, whose result the comparison uses)
        and ``kern`` (5 launches after a warm-up) by CUDA events; ``shape`` =
        (P, M, N, D, f[, rows[, W]]) for the bound; ``tag``: a second shape
        of the same kernel, kept beside the first; ``library``: the PyTorch
        ops the kernel replaces, timed once after a warm-up."""
        got = kern()  # warm-up
        want, plain_ms = event_call(plain)
        r = cmp(kind, dtype, got, want, lim,
                f"{instances[(kind, dtype)]} at {where}")
        del got, want
        library_ms = None
        if library is not None:
            library()
            _, library_ms = event_call(library)
            torch.cuda.empty_cache()
        ms = event_ms(kern, 5)
        b, o = work(kind, *shape[:5], torch.empty((), dtype=dtype)
                    .element_size(), *shape[5:])
        bound_ms, by = bound(b, o, name[dtype])
        timing[(kind, dtype) + ((tag,) if tag else ())] = (
            ms, plain_ms, bound_ms, by, where, library_ms)
        earlier = EARLIER_MS.get((kind, name[dtype])) if not tag else None
        before = f" (one-block design: {earlier:.3f} ms)" if earlier else ""
        lib = (f", the PyTorch ops it replaces {library_ms:.3f} ms"
               if library_ms is not None else "")
        print(f"[t] {instances[(kind, dtype)]}: {where}: kernel {ms:.3f} ms"
              f"{before}, plain {plain_ms:.3f} ms{lib}, bound {bound_ms:.3f} "
              f"ms ({by}; {b} bytes, {o} operations), err {r:.2e} ({card})")
        torch.cuda.empty_cache()

    P = TIMED_PAIRS
    Xt64 = make_paths(gen, P, L, 3, F64)
    Yt64 = make_paths(gen, P, L, 3, F64)
    Gt64 = make_paths(gen, P, L, 3, F64)
    ar = torch.arange(P, device=dev)
    at = f"{P} pairs, len {L}, dyadic 1, dim 3"
    ns = (P, L, L, 3, 2)
    for dtype in (F32, F64):
        Xt, Yt = Xt64.to(dtype), Yt64.to(dtype)
        inc = double_difference(rbf.batch_kernel(Xt, Yt)).contiguous()
        limit = F64_RTOL if dtype == F64 else F32_RTOL_LONG
        glimit = GRAD_F64 if dtype == F64 else GRAD_F32
        timed("gen", dtype,
              lambda: cuda_gen.rbf_gen_solve_final(Xt, Yt, ar, ar, 1.0, 1),
              lambda: cuda_gen.rbf_gen_solve_final_plain(Xt, Yt, ar, ar, 1.0,
                                                         1), compare, limit,
              ns, at)
        timed("inc", dtype, lambda: cuda_solver.inc_solve_final(inc, 1),
              lambda: cuda_solver.inc_solve_final_plain(inc, 1), compare,
              limit, ns, at)
        timed("gen_stack", dtype,
              lambda: cuda_gen.rbf_gen_solve_stack(Xt, Yt, ar, ar, 1.0, 1)[1],
              lambda: cuda_gen.rbf_gen_solve_stack_plain(Xt, Yt, ar, ar, 1.0,
                                                         1)[1],
              compare_max, glimit, ns, at)
        timed("inc_stack", dtype,
              lambda: cuda_solver.inc_solve_stack(inc, 1)[1],
              lambda: cuda_solver.inc_solve_stack_plain(inc, 1)[1],
              compare_max, glimit, ns, at)
        _, stk = cuda_gen.rbf_gen_solve_stack(Xt, Yt, ar, ar, 1.0, 1)
        timed("adj_gen", dtype,
              lambda: cuda_gen.rbf_gen_adjoint(Xt, Yt, ar, ar, 1.0, stk, 1),
              lambda: cuda_gen.rbf_gen_adjoint_plain(Xt, Yt, ar, ar, 1.0,
                                                     stk, 1),
              compare_max, glimit, ns, at)
        ct = cuda_gen.rbf_gen_adjoint(Xt, Yt, ar, ar, 1.0, stk, 1)
        del stk
        _, stk = cuda_solver.inc_solve_stack(inc, 1)
        timed("adj_inc", dtype, lambda: cuda_solver.inc_adjoint(inc, stk, 1),
              lambda: cuda_solver.inc_adjoint_plain(inc, stk, 1),
              compare_max, glimit, ns, at)
        del stk
        timed("vjp", dtype,
              lambda: incvjp.rbf_dd_vjp(Xt, Yt, ar, ar, 1.0, ct)[1],
              lambda: incvjp.rbf_dd_vjp_plain(Xt, Yt, ar, ar, 1.0, ct)[1],
              compare_max, glimit, ns, at)
        Pt, tail = VJP_TAIL, ar[:VJP_TAIL]
        ctt = ct[:Pt].contiguous()
        timed("vjp", dtype,
              lambda: incvjp.rbf_dd_vjp(Xt, Yt, tail, tail, 1.0, ctt)[1],
              lambda: incvjp.rbf_dd_vjp_plain(Xt, Yt, tail, tail, 1.0,
                                              ctt)[1],
              compare_max, glimit, (Pt,) + ns[1:],
              f"{Pt} pairs (the tail chunk), len {L}, dyadic 1, dim 3",
              tag="tail")
        del ct, ctt
        W = cuda_solver.CKPT_WINDOW
        timed("inc_sparse", dtype,
              lambda: cuda_solver.inc_solve_sparse(inc, 1)[1],
              lambda: cuda_solver.inc_solve_sparse_plain(inc, 1)[1],
              compare_max, glimit, ns + (0, W), at)
        _, sparse = cuda_solver.inc_solve_sparse(inc, 1)
        timed("adj_ckpt", dtype,
              lambda: cuda_solver.inc_adjoint_ckpt(inc, sparse, 1),
              lambda: cuda_solver.inc_adjoint_ckpt_plain(inc, sparse, 1),
              compare_bits, glimit, ns + (0, W), at)
        del sparse, inc
        # K8 at phase 12's shape (len 1,024, dyadic 2, dim 5: R 4,092)
        X5 = make_paths(gen, P, L12, D12, dtype)
        Y5 = make_paths(gen, P, L12, D12, dtype)
        inc = double_difference(rbf.batch_kernel(X5, Y5)).contiguous()
        del X5, Y5
        c = PLAIN_CKPT_CHUNK
        timed("inc_sparse", dtype,
              lambda: cuda_solver.inc_solve_sparse(inc, dy12)[1],
              lambda: torch.cat([cuda_solver.inc_solve_sparse_plain(
                  inc[s:s + c], dy12)[1] for s in range(0, P, c)]),
              compare_bits, glimit, (P, L12, L12, D12, 2 ** dy12, 0, W),
              f"{P} pairs, len {L12}, dyadic {dy12}, dim {D12} (phase 12's "
              f"frame; the plain version {c} pairs a call)", tag="phase 12")
        _, sparse = cuda_solver.inc_solve_sparse(inc, dy12)
        timed("adj_ckpt", dtype,
              lambda: cuda_solver.inc_adjoint_ckpt(inc, sparse, dy12),
              lambda: torch.cat([cuda_solver.inc_adjoint_ckpt_plain(
                  inc[s:s + c], sparse[s:s + c], dy12)
                  for s in range(0, P, c)]),
              compare_bits, glimit, (P, L12, L12, D12, 2 ** dy12, 0, W),
              f"{P} pairs, len {L12}, dyadic {dy12}, dim {D12} (phase 12's "
              f"frame; the plain version {c} pairs a call)", tag="phase 12")
        del sparse, inc
        # K9, and K4 on its grids as a cotangent, at longpath.scoring's call
        # (560 pairs, len 1,024, dim 5), pairs drawn over 32 x and 33 y paths
        P9 = SCORING_PAIRS
        X9 = make_paths(gen, 32, L12, D12, dtype)
        Y9 = make_paths(gen, 33, L12, D12, dtype)
        i9 = torch.randint(0, 32, (P9,), generator=gen, device=dev)
        j9 = torch.randint(0, 33, (P9,), generator=gen, device=dev)
        at9 = (f"{P9} pairs, len {L12}, dim {D12} (longpath.scoring's "
               "call)")
        timed("incr", dtype,
              lambda: cuda_gen.rbf_gen_increments(X9, Y9, i9, j9, 1.0),
              lambda: cuda_gen.rbf_gen_increments_plain(X9, Y9, i9, j9, 1.0),
              compare_bits, limit, (P9, L12, L12, D12, 1), at9,
              library=lambda: double_difference(skt.RBFKernel(1.0)
                                                .batch_kernel(X9[i9], Y9[j9])))
        ct9 = cuda_gen.rbf_gen_increments(X9, Y9, i9, j9, 1.0)
        timed("vjp", dtype,
              lambda: incvjp.rbf_dd_vjp(X9, Y9, i9, j9, 1.0, ct9)[1],
              lambda: incvjp.rbf_dd_vjp_plain(X9, Y9, i9, j9, 1.0, ct9)[1],
              compare_max, glimit, (P9, L12, L12, D12, 1), at9, tag="scoring")
        del X9, Y9, ct9
        torch.cuda.empty_cache()
        # K10, and K11 on its grids as a cotangent, at the Linear training
        # cell's chunk, beside the PyTorch grid and its autograd VJP
        at_, bt_ = (cuda_lgen.scaled_increments(t, 1.0) for t in (Xt, Yt))
        timed("lincr", dtype,
              lambda: cuda_lgen.linear_gen_increments(at_, bt_, ar, ar),
              lambda: cuda_lgen.linear_gen_increments_plain(at_, bt_, ar, ar),
              compare_bits, limit, ns[:4] + (1,), at,
              library=lambda: torch_linear_grid(Xt, Yt))
        ctl = cuda_lgen.linear_gen_increments(at_, bt_, ar, ar)
        timed("lvjp", dtype,
              lambda: torch.cat(cuda_lgen.linear_dd_vjp(at_, bt_, ar, ar,
                                                        ctl), 1),
              lambda: torch.cat(cuda_lgen.linear_dd_vjp_plain(at_, bt_, ar,
                                                              ar, ctl), 1),
              compare_max, LINEAR_VJP[name[dtype]], ns[:4] + (1,), at,
              library=lambda: torch_linear_grid(Xt, Yt, ctl))
        del ctl
        torch.cuda.empty_cache()
        nlimit = F64_RTOL if dtype == F64 else NEW_F32
        timed("lgen", dtype,
              lambda: cuda_lgen.linear_gen_solve_final(Xt, Yt, ar, ar, 1.0, 1),
              lambda: cuda_lgen.linear_gen_solve_final_plain(Xt, Yt, ar, ar,
                                                             1.0, 1),
              compare, nlimit, ns, at)
        grids = deriv_grids(rbf, Xt, Yt, Gt64.to(dtype), ar, ar)
        timed("deriv", dtype,
              lambda: torch.stack(cuda_deriv.deriv_solve_final(*grids, 1)),
              lambda: torch.stack(cuda_deriv.deriv_solve_final_plain(*grids,
                                                                     1)),
              compare_max, nlimit, ns, at)
        del grids
    del Xt64, Yt64, Gt64
    torch.cuda.empty_cache()

    # the stripe kernels at phase 10's grid: K7 at the forward's stripe
    # height, K7-stack and K3<inc, boundary> at the adjoint's
    Ps = TIMED_STRIPE_PAIRS
    ring = torch.arange(Ps, device=dev) % n_gram
    for dtype in (F32, F64):
        X = XL.to(dtype)
        inc = double_difference(rbf.batch_kernel(
            X[ring], X[(ring + 1) % n_gram])).contiguous()
        del X
        f, size = 2 ** dy10, inc.element_size()
        C = inc.shape[-1] * f
        ones = inc.new_ones(Ps, C + 1)
        limit = F64_RTOL if dtype == F64 else F32_RTOL_LONG
        glimit = GRAD_F64 if dtype == F64 else GRAD_F32
        rows = cuda_blocked.stripe_rows(dy10, size)
        shape = (Ps, L10, L10, D10, f)
        timed("stripe", dtype,
              lambda: cuda_blocked.stripe_solve(inc, ones, 0, rows, dy10),
              lambda: cuda_blocked.stripe_solve_plain(inc, ones, 0, rows,
                                                      dy10),
              compare, limit, shape + (rows,),
              f"{Ps} pairs, len {L10}, dyadic {dy10}, one stripe of {rows} "
              "rows")
        rows = cuda_blocked.adjoint_rows(dy10, size)
        where = (f"{Ps} pairs, len {L10}, dyadic {dy10}, one stripe of "
                 f"{rows} rows")
        # K7 at the striped adjoint's height, where most of its launches run
        timed("stripe", dtype,
              lambda: cuda_blocked.stripe_solve(inc, ones, 0, rows, dy10),
              lambda: cuda_blocked.stripe_solve_plain(inc, ones, 0, rows,
                                                      dy10),
              compare, limit, shape + (rows,), where, tag="adjoint")
        timed("stripe_stack", dtype,
              lambda: cuda_blocked.stripe_solve_stack(inc, ones, 0, rows,
                                                      dy10)[1],
              lambda: cuda_blocked.stripe_solve_stack_plain(inc, ones, 0,
                                                            rows, dy10)[1],
              compare_max, glimit, shape + (rows,), where)
        _, stk = cuda_blocked.stripe_solve_stack(inc, ones, 0, rows, dy10)
        timed("adj_stripe", dtype,
              lambda: cuda_blocked.stripe_adjoint(
                  inc, stk, ones, torch.zeros_like(inc), 0, rows, dy10),
              lambda: cuda_blocked.stripe_adjoint_plain(
                  inc, stk, ones, torch.zeros_like(inc), 0, rows, dy10),
              compare_max, glimit, shape + (rows,), where)
        del stk, inc, ones
        torch.cuda.empty_cache()

    adjoint = "sigkernel_tpu/ops/pallas_adjoint.py"
    blocked = "sigkernel_tpu/ops/pallas_blocked.py"
    replaces = {
        ("gen", F32): ("sigkernel_tpu/ops/pallas_gen32.py:143",
                       ["sigkernel_tpu/ops/pallas_fused.py:193",
                        "sigkernel_tpu/ops/pallas_fused.py:351"]),
        ("gen", F64): ("sigkernel_tpu/ops/pallas_df64.py:1066", []),
        ("gen_stack", F32): ("sigkernel_tpu/ops/pallas_gen32.py:143",
                             ["sigkernel_tpu/ops/pallas_gen32.py:347"]),
        ("gen_stack", F64): ("sigkernel_tpu/ops/pallas_df64.py:1066",
                             ["sigkernel_tpu/ops/pallas_df64.py:1770"]),
        ("inc", F32): ("sigkernel_tpu/ops/pallas_solver.py:115",
                       ["sigkernel_tpu/ops/pallas_solver.py:764"]),
        ("inc", F64): ("sigkernel_tpu/ops/pallas_df64.py:298",
                       ["sigkernel_tpu/ops/pallas_df64.py:607"]),
        ("inc_stack", F32): ("sigkernel_tpu/ops/pallas_solver.py:115",
                             ["sigkernel_tpu/ops/pallas_solver.py:764"]),
        ("inc_stack", F64): ("sigkernel_tpu/ops/pallas_df64.py:298",
                             ["sigkernel_tpu/ops/pallas_df64.py:607"]),
        ("inc_sparse", F32): ("sigkernel_tpu/ops/pallas_df64.py:298",
                              ["sigkernel_tpu/ops/pallas_df64.py:1844"]),
        ("inc_sparse", F64): ("sigkernel_tpu/ops/pallas_df64.py:298",
                              ["sigkernel_tpu/ops/pallas_df64.py:1844"]),
        ("adj_gen", F32): (f"{adjoint}:1552", [f"{adjoint}:781"]),
        ("adj_gen", F64): (f"{adjoint}:1127", [f"{adjoint}:781"]),
        ("adj_inc", F32): (f"{adjoint}:215", [f"{adjoint}:64",
                                              f"{adjoint}:442"]),
        ("adj_inc", F64): (f"{adjoint}:215", [f"{adjoint}:64",
                                              f"{adjoint}:442"]),
        ("adj_ckpt", F32): (f"{adjoint}:1882", []),
        ("adj_ckpt", F64): (f"{adjoint}:1882", []),
        ("vjp", F32): ("sigkernel_tpu/ops/pallas_incvjp.py:61", []),
        ("vjp", F64): ("sigkernel_tpu/ops/pallas_incvjp.py:61", []),
        ("deriv", F32): ("sigkernel_tpu/ops/pallas_derivatives.py:45", []),
        ("deriv", F64): ("sigkernel_tpu/ops/pallas_derivatives.py:270", []),
        ("lgen", F32): ("sigkernel_tpu/ops/pallas_fused.py:36", []),
        ("lgen", F64): ("sigkernel_tpu/ops/pallas_fused.py:36", []),
        ("stripe", F32): (f"{blocked}:76", []),
        ("stripe", F64): (f"{blocked}:415", []),
        ("stripe_stack", F32): (f"{blocked}:200", []),
        ("stripe_stack", F64): (f"{blocked}:555", []),
        # K9, K10 and K11 replace no TPU kernel: the JAX package leaves the
        # increment grid's build and its VJP to XLA (``library_ms``: the
        # PyTorch ops in their place)
        ("incr", F32): (None, []),
        ("incr", F64): (None, []),
        ("lincr", F32): (None, []),
        ("lincr", F64): (None, []),
        ("lvjp", F32): (None, []),
        ("lvjp", F64): (None, []),
        # the reverse stripe's grid kernel, and the product and collapse
        # that adjoint_blocked / adjoint_blocked_df run in XLA
        ("adj_stripe", F32): (f"{blocked}:200", [f"{blocked}:346"]),
        ("adj_stripe", F64): (f"{blocked}:555", [f"{blocked}:700"]),
    }
    source = {"gen": "rbf_gen_wavefront.cu",
              "gen_stack": "rbf_gen_wavefront.cu",
              "inc": "inc_wavefront.cu", "inc_stack": "inc_wavefront.cu",
              "inc_sparse": "inc_wavefront.cu",
              "adj_gen": "adjoint_collapse.cu",
              "adj_inc": "adjoint_collapse.cu",
              "adj_stripe": "adjoint_collapse.cu",
              "adj_ckpt": "adjoint_ckpt.cu", "vjp": "rbf_dd_vjp.cu",
              "deriv": "deriv_wavefront.cu",
              "lgen": "linear_gen_wavefront.cu",
              "stripe": "stripe_wavefront.cu",
              "stripe_stack": "stripe_wavefront.cu",
              "incr": "rbf_gen_increments.cu",
              "lincr": "linear_gen_increments.cu",
              "lvjp": "linear_dd_vjp.cu"}
    check(set(instances) <= {k[:2] for k in timing}, "a kernel was not timed")
    kernels = []
    for tkey in timing:
        key = tkey[:2]
        iname, (rep, also) = instances[key], replaces[key]
        ms, plain_ms, bound_ms, by, where, library_ms = timing[tkey]
        # no single PyTorch call computes a wavefront sweep or its adjoint;
        # K9's, K10's and K11's are PyTorch ops (``library_ms``)
        kernels.append({"name": iname, "route": "cuda",
                        "source": f"sigkernel_tpu_torch/csrc/{source[key[0]]}",
                        "replaces": rep, "also_replaces": also,
                        "launches": launches[key],
                        "max_abs_err": max_abs[key], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": by, "library_ms": library_ms,
                        "at": where})
    print(f"[t] chip_smoke.py ran {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
