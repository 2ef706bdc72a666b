"""The Linear training cell ``northstar_linear.train``: its counts, and its
runs at a tiny size on the CPU's plain tier and on the ``lgen`` route
(steered, its plain versions behind it), with the timed path whole and
broken."""
import json
import time

import pytest
import torch

import sigkernel_tpu_torch as skt
from bench_torch import harness, work
from bench_torch.calibrate import readings
from sigkernel_tpu_torch import sigkernel
from sigkernel_tpu_torch.ops import cuda_lgen, routes

from conftest import ROOT, shrink

CPU = torch.device("cpu")
CELL = "northstar_linear.train"
# the relative change of an altered answer
ALTER = 1e-4


def _cell(root=ROOT):
    return harness.Cell(CELL, root)


def test_pairs_and_outputs_a_call():
    c = _cell()
    assert c.pairs() == 100 * 101 // 2 == 5_050
    # the value, dX (100 paths of 1,024 x 3) and dscale
    assert c.kind.floats_out(c.mix, c.config) == 1 + 100 * 1024 * 3 + 1 \
        == 307_202


def test_the_least_time_counts_the_triangle():
    c = _cell()
    # 2,046^2 refined cells at 10 + 12 operations, 1,023^2 base cells at
    # 5, 1,024^2 point pairs at the Linear kernel's 2 D + 1 and 4 D + 2
    ops = 5_050 * (22 * 2_046 ** 2 + 5 * 1_023 ** 2 + 21 * 1_024 ** 2)
    assert ops == 5_050 * 119_347_293
    assert c.least_seconds() == pytest.approx(
        work.least_seconds(100 * 1024 * 3 + 307_202, ops, "float64"),
        rel=1e-12)
    assert c.least_seconds() == pytest.approx(ops / 34e12, rel=1e-12)


@pytest.fixture
def linear_root(tiny_root):
    """The tiny copy, with this cell's mix at 4 paths."""
    p = tiny_root / "bench_torch" / "traffic" / "lincomb_sym_train.json"
    mix = json.loads(p.read_text())
    mix["paths"] = {"X": 4}
    p.write_text(json.dumps(mix))
    return tiny_root


@pytest.fixture(params=["plain", "lgen"])
def family(request, monkeypatch):
    """``lgen``: ``LinearKernel`` tiles take the Linear generator's family,
    whose Function runs the plain versions of K6, K2-stack and K3<inc> on
    CPU tensors."""
    if request.param == "lgen":
        orig = routes.resolve_family

        def steered(static_kernel, device_type, solver, **gates):
            if type(static_kernel) is skt.LinearKernel:
                return "lgen"
            return orig(static_kernel, device_type, solver, **gates)

        monkeypatch.setattr(routes, "resolve_family", steered)
    return request.param


def test_a_tiny_run_is_correct_and_names_its_outputs(linear_root, family):
    c = _cell(linear_root)
    before = cuda_lgen.COUNTS["plain"]
    res = harness.run_cell(c, 2 ** 33 + 3, 0.2, False, CPU,
                           time.perf_counter())
    assert (cuda_lgen.COUNTS["plain"] > before) == (family == "lgen")
    assert res["correct"] is True, res["checks"]
    assert set(res["checks"]) == {"value", "dX", "dscale"}
    assert res["failed"] == 0 and res["attempted"] >= 1
    # untraced, on the CPU: no device memory to read
    assert set(res["metrics"]) == {"setup_s", "train_pairs_per_s"}


def test_the_control_fails_the_limits(linear_root, family):
    shrink(linear_root, length=32, dim=3)
    c = _cell(linear_root)
    sound, _ = readings(c, 3, torch.float64, CPU, skt)
    control, _ = readings(c, 3, torch.float32, CPU, skt)
    assert all(v <= c.limits[k] for k, v in sound.items()), sound
    assert any(v > c.limits[k] for k, v in control.items()), control


def _break(monkeypatch, fault):
    """Break the timed path underneath the kind."""
    if fault == "no_doubling":
        # the triangle's off-diagonal pairs weighted once, not twice
        orig = sigkernel._lincomb_pairs

        def once(A, B, W, sym):
            ii, jj, w = orig(A, B, W, sym)
            return ii, jj, W[ii, jj] if sym else w

        monkeypatch.setattr(sigkernel, "_lincomb_pairs", once)
        return
    orig = skt.sig_gram_lincomb

    def broken(kernel, X, Y, W, **kw):
        if fault == "one_slot":          # X's gradient from one slot alone
            return orig(kernel, X, Y.detach(), W, **kw)
        if fault == "scale_grad":        # scale's gradient altered
            kernel.scale.register_hook(lambda g: g * (1 + ALTER))
            return orig(kernel, X, Y, W, **kw)
        S = orig(kernel, X, Y, W, **kw)  # "answer": the value altered
        return S + ALTER * S.detach().abs()

    monkeypatch.setattr(skt, "sig_gram_lincomb", broken)


@pytest.mark.parametrize("fault", ["no_doubling", "one_slot", "scale_grad",
                                   "answer"])
def test_a_broken_timed_path_is_not_correct(linear_root, monkeypatch,
                                            family, fault):
    c = _cell(linear_root)
    _break(monkeypatch, fault)
    res = harness.run_cell(c, 9, 0.2, False, CPU, time.perf_counter())
    assert res["correct"] is False, res["checks"]
    assert any(ch["value"] is None or ch["value"] > ch["limit"]
               for ch in res["checks"].values())
