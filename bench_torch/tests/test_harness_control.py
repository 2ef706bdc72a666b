"""The comparison that decides ``correct`` must fail: the control (the
program's float32 path, the precision below the configurations' float64)
at a size a test run holds, and a run whose timed path is broken
underneath, once for each fault a cell can have."""
import time

import pytest
import torch

import sigkernel_tpu_torch as skt
from bench_torch import harness
from bench_torch.calibrate import readings

from conftest import CELLS, shrink

CPU = torch.device("cpu")
# the relative change of an altered answer
ALTER = 1e-4


@pytest.fixture
def small_root(tiny_root):
    """The tiny copy at 64 points of dim 3: float32 drifts measurably."""
    shrink(tiny_root, length=64, dim=3)
    return tiny_root


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_limits(small_root, cell):
    c = harness.Cell(cell, small_root)
    sound, _ = readings(c, 3, torch.float64, CPU, skt)
    control, _ = readings(c, 3, torch.float32, CPU, skt)
    assert all(v <= c.limits[k] for k, v in sound.items()), sound
    assert any(v > c.limits[k] for k, v in control.items()), control


def _fault(monkeypatch, kind, fault):
    """Break the program's entry that ``kind`` calls."""
    if kind == "gram_sym":
        orig = skt.SigKernel.compute_Gram

        def gram(self, X, Y, sym=False, max_batch=100):
            if fault == "answer":
                K = orig(self, X, Y, sym, max_batch).clone()
                K[0, -1] *= 1 + ALTER
                return K
            h = X.shape[0] // 2                 # half the batch left out
            Kh = orig(self, X[:h], Y[:h], sym, max_batch)
            K = Kh.new_full((X.shape[0], Y.shape[0]), float(Kh.mean()))
            K[:h, :h] = Kh
            return K

        monkeypatch.setattr(skt.SigKernel, "compute_Gram", gram)
        return
    name = {"lincomb": "sig_gram_lincomb", "scoring_rule": "sig_scoring_rule",
            "chsic": "sig_chsic"}[kind]
    orig = getattr(skt, name)

    def broken(*args, **kw):
        if fault == "answer":
            return orig(*args, **kw) * (1 + ALTER)
        if fault == "unchanged":                # no gradient reaches the inputs
            with torch.no_grad():
                v = orig(*args, **kw)
            kern, *paths = args[:3]
            return v + 0.0 * (sum(p.sum() for p in paths) + kern.sigma)
        # half the batch left out: the estimator of the other half
        if kind == "chsic":
            h = args[0].shape[0] // 2
            return orig(*(a[:h] for a in args[:3]), *args[3:], **kw)
        kern, X, Y, *rest = args
        h = X.shape[0] // 2
        if kind == "lincomb":
            W = rest[0]
            return orig(kern, X[:h], Y, W[:h] * (X.shape[0] / h), **kw)
        return orig(kern, X[:h], Y, *rest, **kw)

    monkeypatch.setattr(skt, name, broken)


FAULTS = [(c, f) for c in CELLS for f in ("answer", "half")] + [
    (c, "unchanged") for c in ("northstar.train", "longpath.scoring")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell,
                                            fault):
    c = harness.Cell(cell, tiny_root)
    assert harness.run_cell(c, 9, 0.2, False, CPU,
                            time.perf_counter())["correct"] is True
    _fault(monkeypatch, c.mix["kind"], fault)
    res = harness.run_cell(c, 9, 0.2, False, CPU, time.perf_counter())
    assert res["correct"] is False, res["checks"]
