"""The plain reference against the program's CPU path (the scan tier), at
tiny sizes: values, Grams, CHSIC and the adjoint-PDE gradients."""
import math
import subprocess
import sys

import pytest
import torch

import sigkernel_tpu_torch as skt
from bench_torch import reference as ref

from conftest import ROOT

F64 = torch.float64
RBF = ref.static_kernel("RBFKernel")
LIN = ref.static_kernel("LinearKernel")
SHAPES = [(3, 4, 6, 5, 2, 0), (3, 4, 7, 9, 3, 1), (2, 3, 5, 5, 2, 2),
          (2, 2, 9, 4, 1, 1)]


def paths(gen, n, L, D):
    z = torch.randn(n, L, D, generator=gen, dtype=F64)
    return z.cumsum(1) / math.sqrt(L)


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("shape", SHAPES)
def test_lincomb_and_gradients(shape):
    n, m, L, Ly, D, d = shape
    g = torch.Generator().manual_seed(1)
    X, Y = paths(g, n, L, D), paths(g, m, Ly, D)
    W = torch.randn(n, m, generator=g, dtype=F64)
    s = torch.tensor(0.7, dtype=F64)
    Xg, Yg, sg = (t.clone().requires_grad_() for t in (X, Y, s))
    S = skt.sig_gram_lincomb(skt.RBFKernel(sg), Xg, Yg, W, dyadic_order=d)
    S.backward()
    Sr, dX, dY, ds = ref.lincomb_grads(X, Y, W, RBF.Kernel(s), 2 ** d)
    for got, want in ((Sr, S.detach()), (dX, Xg.grad), (dY, Yg.grad),
                      (ds, sg.grad)):
        assert rel(got, want) < 1e-12


@pytest.mark.parametrize("shape", SHAPES)
def test_linear_kernel_lincomb_and_gradients(shape):
    n, m, L, Ly, D, d = shape
    g = torch.Generator().manual_seed(6)
    X, Y = paths(g, n, L, D), paths(g, m, Ly, D)
    W = torch.randn(n, m, generator=g, dtype=F64)
    s = torch.tensor(0.8, dtype=F64)
    Xg, Yg, sg = (t.clone().requires_grad_() for t in (X, Y, s))
    S = skt.sig_gram_lincomb(skt.LinearKernel(sg), Xg, Yg, W, dyadic_order=d)
    S.backward()
    Sr, dX, dY, ds = ref.lincomb_grads(X, Y, W, LIN.Kernel(s), 2 ** d)
    for got, want in ((Sr, S.detach()), (dX, Xg.grad), (dY, Yg.grad),
                      (ds, sg.grad)):
        assert rel(got, want) < 1e-12


def test_an_unknown_static_kernel_is_refused():
    with pytest.raises(ValueError, match="unknown static kernel 'Cubic'"):
        ref.static_kernel("Cubic")


@pytest.mark.parametrize("shape", SHAPES)
def test_scoring_rule_and_gradients(shape):
    n, _, L, _, D, d = shape
    g = torch.Generator().manual_seed(2)
    X, y = paths(g, n + 1, L, D), paths(g, 1, L, D)
    s = torch.tensor(1.3, dtype=F64)
    Xg, sg = X.clone().requires_grad_(), s.clone().requires_grad_()
    v = skt.sig_scoring_rule(skt.RBFKernel(sg), Xg, y, dyadic_order=d)
    v.backward()
    vr, dX, dY, ds = ref.scoring_rule_grads(X, y, RBF.Kernel(s), 2 ** d)
    assert dY is None
    for got, want in ((vr, v.detach()), (dX, Xg.grad), (ds, sg.grad)):
        assert rel(got, want) < 1e-12


@pytest.mark.parametrize("shape", SHAPES)
def test_gram_and_chsic(shape):
    n, _, L, _, D, d = shape
    g = torch.Generator().manual_seed(3)
    X, Y, Z = (paths(g, n + 2, L, D) for _ in range(3))
    one = torch.tensor(1.0, dtype=F64)
    G = skt.SigKernel(skt.RBFKernel(1.0), d).compute_Gram(X, X, sym=True)
    assert rel(ref.gram_sym(X, RBF.Kernel(one), 2 ** d), G) < 1e-12
    c = skt.sig_chsic(X, Y, Z, skt.RBFKernel(1.0), dyadic_order=d)
    assert rel(ref.chsic(X, Y, Z, RBF.Kernel(one), 2 ** d, 0.1), c) < 1e-10


def test_blocks_and_sub_blocks_change_nothing(monkeypatch):
    g = torch.Generator().manual_seed(4)
    X, Y = paths(g, 3, 7, 2), paths(g, 4, 6, 2)
    W = torch.randn(3, 4, generator=g, dtype=F64)
    s = torch.tensor(0.9, dtype=F64)
    whole = ref.lincomb_grads(X, Y, W, RBF.Kernel(s), 2)
    monkeypatch.setattr(ref, "_budget", lambda device: 1)   # a pair a block
    monkeypatch.setattr(ref, "SUB_PAIRS", 1)
    assert ref.block_pairs(7, 6, 2, 8, True, 1) == 1
    for a, b in zip(whole, ref.lincomb_grads(X, Y, W, RBF.Kernel(s), 2)):
        assert rel(b, a) < 1e-14


@pytest.mark.parametrize("Mb,Nb,f", [(3, 4, 1), (4, 3, 2), (1, 5, 2),
                                     (5, 1, 1)])
def test_sweep_matches_the_scheme_cell_by_cell(Mb, Nb, f):
    g = torch.Generator().manual_seed(5)
    inc = 0.3 * torch.randn(Mb, Nb, 2, generator=g, dtype=F64)
    R, C = Mb * f, Nb * f
    K = torch.ones(R + 1, C + 1, 2, dtype=F64)
    for i in range(R):
        for j in range(C):
            u = inc[i // f, j // f] / (f * f)
            K[i + 1, j + 1] = ((K[i + 1, j] + K[i, j + 1]) * (1 + u / 2 + u * u / 12)
                               - K[i, j] * (1 - u * u / 12))
    assert rel(ref.sweep_values(inc.clone(), f), K[R, C]) < 1e-14
    v, _ = ref.sweep_grad(inc.clone(), f)
    assert rel(v, K[R, C]) < 1e-14


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import bench_torch.reference;"
            " bad = [m for m in sys.modules if m.startswith(('sigkernel', 'jax'))];"
            " assert not bad, bad" % str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True)
