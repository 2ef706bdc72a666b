"""The benchmark's plain reference: signature kernels of a static kernel's
increments, their gradients, and the estimators the traffic calls, in plain
PyTorch.

It imports nothing of the program under test and takes nothing the program
made: the increments are built here from the paths and the static kernel
that the configuration names (``static_kernels/<name>.py``, its values and
their VJP in plain PyTorch), the Goursat PDE is swept here, and its adjoint
is worked out here by hand. It is what decides ``correct``.

Layout: pairs are the innermost axis, so every operation on an
anti-diagonal reads and writes runs of ``B`` contiguous values. A refined
cell ``(i, j)`` of the ``(R, C)`` grid carries ``u = inc[i // f, j // f] /
f^2`` and the order-2 scheme::

    K[i+1, j+1] = (K[i+1, j] + K[i, j+1]) a(u) - K[i, j] b(u)
    a(u) = 1 + u/2 + u^2/12,  b(u) = 1 - u^2/12,  K[0, :] = K[:, 0] = 1

The value is ``K[R, C]``. Its gradient in the refined increment of cell
``(i, j)`` is that of the adjoint PDE, as the original signature-kernel
library has it: ``K[i, j] K_rev[R-1-i, C-1-j]``, with ``K_rev`` the
solution for the increments flipped along both axes; a base cell's is the
sum over its ``f x f`` refined cells, over ``f^2``.
"""
from __future__ import annotations

from pathlib import Path

import torch

from . import named

BENCH = Path(__file__).resolve().parent

# pairs whose (M, N) grids are built at a time
SUB_PAIRS = 64


class Plan:
    """Index arrays of one refined ``(R, C)`` grid, refinement ``f``:
    for each cell anti-diagonal ``k = i + j`` its rows ``lo[k]..hi[k]``,
    the flat base-cell index of each of its cells (``base[off[k]:off[k] +
    n[k]]``; of cell ``(R-1-i, C-1-j)`` with ``flip``), and where each
    ``K`` anti-diagonal's stored rows start."""

    def __init__(self, Mb: int, Nb: int, f: int, device, flip=False):
        R, C = Mb * f, Nb * f
        self.R, self.C, self.f, self.Mb, self.Nb = R, C, f, Mb, Nb
        ks = range(R + C - 1)
        self.lo = [max(0, k - C + 1) for k in ks]
        self.hi = [min(k, R - 1) for k in ks]
        n = [h - l + 1 for l, h in zip(self.lo, self.hi)]
        self.off = [0]
        for c in n[:-1]:
            self.off.append(self.off[-1] + c)
        nt = torch.tensor(n, device=device)
        k_of = torch.repeat_interleave(torch.arange(len(n), device=device), nt)
        start = torch.repeat_interleave(
            torch.tensor(self.off, device=device)
            - torch.tensor(self.lo, device=device), nt)
        i = torch.arange(R * C, device=device) - start
        j = k_of - i
        if flip:
            i, j = R - 1 - i, C - 1 - j
        self.base = (i // f) * Nb + j // f
        # K anti-diagonal m keeps rows max(0, m - C)..min(m, R)
        self.klo = [max(0, m - C) for m in range(R + C + 1)]
        sizes = [min(m, R) - lo + 1 for m, lo in enumerate(self.klo)]
        self.koff = [0]
        for c in sizes[:-1]:
            self.koff.append(self.koff[-1] + c)
        self.kcells = self.koff[-1] + sizes[-1]

    def cells(self, k):
        return self.base[self.off[k]:self.off[k] + self.hi[k] - self.lo[k] + 1]


class _Ring:
    """The last three ``K`` anti-diagonals, indexed by row (forward only)."""

    def __init__(self, plan, B, dtype, device):
        self.buf = torch.ones(3, plan.R + 1, B, dtype=dtype, device=device)

    def rows(self, m, a, b):
        return self.buf[m % 3, a:b]


class _Stack:
    """Every ``K`` anti-diagonal's stored rows, for the adjoint."""

    def __init__(self, plan, B, dtype, device):
        self.plan = plan
        self.buf = torch.ones(plan.kcells, B, dtype=dtype, device=device)

    def rows(self, m, a, b):
        s = self.plan.koff[m] - self.plan.klo[m]
        return self.buf[s + a:s + b]


def _coefficients(inc, f):
    """``a, b`` of the refined cells, on the base grid ``(Mb * Nb, B)``;
    ``a`` takes ``inc``'s storage."""
    u = inc.div_(f * f)
    b = u.square().div_(-12.0).add_(1.0)
    return u.mul_(0.5).add_(2.0).sub_(b), b     # 1 + u/2 + u^2/12


def _step(plan, a, b, store, k):
    """``K`` anti-diagonal ``k + 2`` from the two before it."""
    lo, hi, idx = plan.lo[k], plan.hi[k], plan.cells(k)
    out = store.rows(k + 2, lo + 1, hi + 2)
    torch.add(store.rows(k + 1, lo + 1, hi + 2),
              store.rows(k + 1, lo, hi + 1), out=out)
    out.mul_(a.index_select(0, idx))
    out.addcmul_(store.rows(k, lo, hi + 1), b.index_select(0, idx),
                 value=-1.0)


def _forward(plan, a, b, store):
    for k in range(plan.R + plan.C - 1):
        _step(plan, a, b, store, k)


def sweep_values(inc, f):
    """``K[R, C]`` of each pair: ``inc`` is the base increment grid ``(Mb,
    Nb, B)``, which the sweep overwrites; returns ``(B,)``."""
    Mb, Nb, B = inc.shape
    if Mb == 0 or Nb == 0:
        return inc.new_ones(B)
    plan = Plan(Mb, Nb, f, inc.device)
    a, b = _coefficients(inc.reshape(Mb * Nb, B), f)
    ring = _Ring(plan, B, inc.dtype, inc.device)
    _forward(plan, a, b, ring)
    return ring.rows(plan.R + plan.C, plan.R, plan.R + 1)[0].clone()


def sweep_grad(inc, f):
    """``(values (B,), d value / d inc (Mb, Nb, B))``, ``inc`` overwritten:
    the forward sweep keeps every ``K`` anti-diagonal; the sweep of the
    flipped increments then meets them cell diagonal by cell diagonal, last
    to first."""
    Mb, Nb, B = inc.shape
    if Mb == 0 or Nb == 0:
        return inc.new_ones(B), torch.zeros_like(inc)
    plan = Plan(Mb, Nb, f, inc.device)
    a, b = _coefficients(inc.reshape(Mb * Nb, B), f)
    K = _Stack(plan, B, inc.dtype, inc.device)
    _forward(plan, a, b, K)
    R, C = plan.R, plan.C
    value = K.rows(R + C, R, R + 1)[0].clone()
    rev = Plan(Mb, Nb, f, inc.device, flip=True)
    ring = _Ring(rev, B, inc.dtype, inc.device)
    g = torch.zeros_like(a)
    for m in range(R + C - 1):
        if m >= 2:
            _step(rev, a, b, ring, m - 2)
        k = R + C - 2 - m
        lo, hi = plan.lo[k], plan.hi[k]
        s = ring.rows(m, R - 1 - hi, R - lo).flip(0)
        g.index_add_(0, plan.cells(k), s.mul_(K.rows(k, lo, hi + 1)))
    return value, (g / (f * f)).reshape(Mb, Nb, B)


def static_kernel(name, bench=BENCH):
    """The static kernel ``name`` of a configuration: its module
    ``static_kernels/<name>.py``, with ``PARAM`` (the configuration's key
    of its parameter), ``Kernel(p)`` (``gram`` and ``vjp`` of point pairs)
    and ``point_ops``. A name with no such file is refused."""
    return named.load(Path(bench) / "static_kernels", name, "static kernel")


def _double_difference(G):
    return G[..., 1:, 1:] + G[..., :-1, :-1] - G[..., 1:, :-1] - G[..., :-1, 1:]


def increments(X, Y, ii, jj, kern):
    """The base increment grids ``(Mb, Nb, B)`` of the pairs ``(X[ii[p]],
    Y[jj[p]])``: the double difference of the static kernel ``kern``'s
    point-pair values, built :data:`SUB_PAIRS` pairs at a time."""
    P, M, N, sub = ii.shape[0], X.shape[1], Y.shape[1], SUB_PAIRS
    inc = X.new_empty(M - 1, N - 1, P)
    for s in range(0, P, sub):
        G, _ = kern.gram(X[ii[s:s + sub]], Y[jj[s:s + sub]])
        inc[:, :, s:s + sub] = _double_difference(G).permute(1, 2, 0)
    return inc


def increments_vjp(kern, x, y, g):
    """Gradients in ``x``, ``y`` and the kernel's parameter of ``sum(g *
    inc)``, ``g`` ``(Mb, Nb, B)`` the cotangent of the base increments."""
    G, aux = kern.gram(x, y)
    ct = torch.nn.functional.pad(g.permute(2, 0, 1), (1, 1, 1, 1))
    return kern.vjp(x, y, G, aux, _double_difference(ct))


def block_pairs(M, N, f, itemsize, grad, budget):
    """Pairs a block whose sweep stays within ``budget`` bytes: ``a``,
    ``b`` and, for a gradient, the stack, the gradient and the reverse
    ring."""
    Mb, Nb = max(M - 1, 0), max(N - 1, 0)
    per = 2 * Mb * Nb + 3 * (Mb * f + 1)
    if grad:
        per += (Mb * f + 1) * (Nb * f + 1) + Mb * Nb + 3 * (Mb * f + 1)
    return max(1, budget // (itemsize * per))


def _budget(device):
    """Half the card's memory (the program's state is freed by then);
    256 MiB on the CPU."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory // 2
    return 1 << 28


def pair_values(X, Y, ii, jj, kern, f):
    """``k(X[ii[p]], Y[jj[p]])`` for every pair, in blocks."""
    B = block_pairs(X.shape[1], Y.shape[1], f, X.element_size(), False,
                    _budget(X.device))
    out = [X.new_zeros(0)]
    for s in range(0, ii.shape[0], B):
        out.append(sweep_values(
            increments(X, Y, ii[s:s + B], jj[s:s + B], kern), f))
    return torch.cat(out)


def weighted_grads(X, Y, ii, jj, w, kern, f):
    """``S = sum_p w_p k(X[ii_p], Y[jj_p])`` and its gradients ``(S, dX,
    dY, dp)``, ``p`` the static kernel's parameter, in blocks of pairs; the
    chain to the paths :data:`SUB_PAIRS` pairs at a time."""
    sub = SUB_PAIRS
    B = block_pairs(X.shape[1], Y.shape[1], f, X.element_size(), True,
                    _budget(X.device))
    S = X.new_zeros(())
    dX, dY, dp = torch.zeros_like(X), torch.zeros_like(Y), X.new_zeros(())
    for s in range(0, ii.shape[0], B):
        i, j, wb = ii[s:s + B], jj[s:s + B], w[s:s + B]
        v, g = sweep_grad(increments(X, Y, i, j, kern), f)
        S = S + torch.sum(wb * v)
        g.mul_(wb)
        for t in range(0, i.shape[0], sub):
            it, jt = i[t:t + sub], j[t:t + sub]
            dx, dy, e = increments_vjp(kern, X[it], Y[jt], g[:, :, t:t + sub])
            dX.index_add_(0, it, dx)
            dY.index_add_(0, jt, dy)
            dp = dp + e
        del g
    return S, dX, dY, dp


def sym_pairs(n, device, diagonal=True):
    """The upper triangle's pairs ``(ii, jj)`` of an ``n x n`` Gram."""
    return torch.triu_indices(n, n, 0 if diagonal else 1, device=device)


def gram_sym(X, kern, f):
    """The symmetric Gram ``k(X_i, X_j)``: the upper triangle, mirrored."""
    n = X.shape[0]
    ii, jj = sym_pairs(n, X.device)
    K = X.new_zeros(n, n)
    K[ii, jj] = pair_values(X, X, ii, jj, kern, f)
    return K + K.T - torch.diag(torch.diag(K))


def chsic(X, Y, Z, kern, f, eps):
    """The signature conditional HSIC of ``X`` and ``Y`` given ``Z``."""
    m = X.shape[0]
    eye = torch.eye(m, dtype=X.dtype, device=X.device)
    H = eye - 1.0 / m
    KX, KY, KZ = (H @ gram_sym(T, kern, f) @ H for T in (X, Y, Z))
    inv = torch.linalg.inv(KZ + m * eps * eye)
    A = KZ @ inv @ inv @ KZ
    Bm = KX @ A @ KY
    return (torch.trace(KX @ KY) - 2.0 * torch.trace(Bm)
            + torch.trace(Bm @ A)) / m ** 2


def lincomb_grads(X, Y, W, kern, f):
    """``sum_ij W_ij k(X_i, Y_j)`` and its gradients in ``X``, ``Y`` and
    the static kernel's parameter."""
    n, m = W.shape
    ii = torch.arange(n, device=X.device).repeat_interleave(m)
    jj = torch.arange(m, device=X.device).repeat(n)
    return weighted_grads(X, Y, ii, jj, W.reshape(-1), kern, f)


def scoring_rule_grads(X, y, kern, f):
    """``offdiag_mean(k(X, X)) - 2 mean(k(X, y))`` and its gradients in
    ``X`` and the static kernel's parameter: the off-diagonal pairs ``i <
    j`` twice, the diagonal not at all."""
    n, m = X.shape[0], y.shape[0]
    ii, jj = sym_pairs(n, X.device, diagonal=False)
    w = X.new_full((ii.shape[0],), 2.0 / (n * (n - 1.0)))
    S1, a, b, e1 = weighted_grads(X, X, ii, jj, w, kern, f)
    ii = torch.arange(n, device=X.device).repeat_interleave(m)
    jj = torch.arange(m, device=X.device).repeat(n)
    w = X.new_full((ii.shape[0],), -2.0 / (n * m))
    S2, c, _, e2 = weighted_grads(X, y, ii, jj, w, kern, f)
    return S1 + S2, a + b + c, None, e1 + e2
