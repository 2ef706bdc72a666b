"""The port's ``SigKernelSVC`` (``sigkernel_tpu_torch.models``): its two
Grams against the benchmark's plain reference (``bench_torch/reference.py``)
on add-time and lead-lag paths in ragged tiles, on the CPU's plain tier and
on the generator's family (steered, its plain versions behind it), and its
predictions against the JAX class's on a synthetic set."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import sigkernel_tpu as sk
from sigkernel_tpu.models import SigKernelSVC as JaxSVC

import sigkernel_tpu_torch as skt
from bench_torch import reference as ref
from sigkernel_tpu_torch.models import SigKernelSVC
from sigkernel_tpu_torch.ops import routes

RBF = ref.static_kernel("RBFKernel")


def _paths(batch, length, dim, seed):
    g = torch.Generator().manual_seed(seed)
    z = torch.randn(batch, length, dim, generator=g, dtype=torch.float64)
    return z.cumsum(1) / length ** 0.5


@pytest.fixture(params=["plain", "gen"])
def family(request, monkeypatch):
    """``gen``: RBF tiles take the generator's family, whose Function runs
    K1's plain version on CPU tensors."""
    if request.param == "gen":
        orig = routes.resolve_family

        def steered(static_kernel, device_type, solver, **gates):
            if solver == "scan":
                return orig(static_kernel, device_type, solver, **gates)
            return "gen"

        monkeypatch.setattr(routes, "resolve_family", steered)
    return request.param


@pytest.mark.parametrize("dyadic", [0, 1])
def test_grams_match_the_reference(family, dyadic):
    """7 train and 6 test paths of 9 steps and 4 channels, add-time and
    lead-lag (17 points of 9 channels), ``max_batch`` 3: the test Gram's
    tiles are 3 x 3 with ragged last rows and columns, the train triangle's
    28 pairs in chunks of 9. Both sides in float64; the reference sums its
    distances in another order, so 1e-12 of the largest value."""
    X = skt.transform(_paths(7, 9, 4, 1), at=True, ll=True, scale=0.5)
    T = skt.transform(_paths(6, 9, 4, 2), at=True, ll=True, scale=0.5)
    svc = SigKernelSVC(skt.RBFKernel(0.7), dyadic, max_batch=3)
    train, test = svc.train_gram(X), svc.test_gram(T)
    kern, f = RBF.Kernel(torch.tensor(0.7, dtype=torch.float64)), 2 ** dyadic
    want_train = ref.gram_sym(X, kern, f)
    ii = torch.arange(6).repeat_interleave(7)
    jj = torch.arange(7).repeat(6)
    want_test = ref.pair_values(T, X, ii, jj, kern, f).reshape(6, 7)
    assert train.shape == (7, 7) and test.shape == (6, 7)
    assert torch.equal(train, train.T)
    for got, want in ((train, want_train), (test, want_test)):
        assert float((got - want).abs().max()) <= 1e-12 * float(
            want.abs().max())


def test_a_sigma_given_as_a_number_is_not_read_from_a_device(family):
    """``RBFKernel(0.7)`` holds sigma on the host: without a gradient the
    Grams make no ``sk.sync.sigma`` read."""
    X = _paths(4, 6, 3, 3)
    svc = SigKernelSVC(skt.RBFKernel(0.7), 0, max_batch=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        svc.train_gram(X)
        svc.test_gram(X[:3])
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("sk.est.sig_gram") == 2
    assert "sk.sync.sigma" not in names


def _class_data(seed, n_per_class=8, length=12, dim=3, n_classes=3):
    """Class-structured paths as the example's ``make_synthetic``: class k
    drifts along a random direction; 70 % train, 30 % test."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n_classes, dim))
    X, y = [], []
    for k in range(n_classes):
        noise = rng.normal(size=(n_per_class, length, dim)) * 0.3
        drift = np.linspace(0, 1, length)[None, :, None] * dirs[k] * 2.0
        X.append(np.cumsum(noise, axis=1) / np.sqrt(length) + drift)
        y += [k] * n_per_class
    X, y = np.concatenate(X), np.array(y)
    perm = rng.permutation(len(y))
    X, y = X[perm], y[perm]
    cut = int(0.7 * len(y))
    return X[:cut], y[:cut], X[cut:], y[cut:]


def test_predictions_match_the_jax_class():
    X, y, T, yt = _class_data(0)
    Xt = sk.transform(X, at=True, ll=True, scale=0.5)
    Tt = sk.transform(T, at=True, ll=True, scale=0.5)
    params = {"C": [1.0, 10.0, 100.0], "gamma": ["auto"]}
    port = SigKernelSVC(skt.RBFKernel(0.5), 0, svc_parameters=params, cv=2,
                        max_batch=5)
    port.fit(torch.from_numpy(Xt), torch.from_numpy(y))
    jax_svc = JaxSVC(sk.RBFKernel(0.5), 0, svc_parameters=params, cv=2,
                     max_batch=5)
    jax_svc.fit(jnp.asarray(Xt), y)
    got = port.predict(torch.from_numpy(Tt))
    assert np.array_equal(got, jax_svc.predict(jnp.asarray(Tt)))
    acc = port.score(torch.from_numpy(Tt), yt)
    assert acc == jax_svc.score(jnp.asarray(Tt), yt)
    assert acc > 0.7


def test_grams_and_predictions_need_their_calls_first():
    svc = SigKernelSVC(skt.RBFKernel(0.5))
    X = torch.zeros(2, 5, 2, dtype=torch.float64)
    for call in (svc.test_gram, svc.predict):
        with pytest.raises(RuntimeError):
            call(X)
    with pytest.raises(RuntimeError):
        svc.score(X, [0, 1])
    svc.train_gram(X)
    assert svc.test_gram(X[:1]).shape == (1, 2)
    with pytest.raises(RuntimeError):
        svc.predict(X)


def test_the_gram_path_imports_no_sklearn():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, torch, sigkernel_tpu_torch as skt\n"
            "svc = skt.models.SigKernelSVC(skt.RBFKernel(0.5))\n"
            "x = skt.transform(torch.rand(3, 5, 2, dtype=torch.float64), "
            "at=True, ll=True)\n"
            "svc.train_gram(x); svc.test_gram(x[:2])\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('sklearn', 'jax', 'sigkernel_tpu'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
