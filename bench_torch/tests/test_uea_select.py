"""The model-selection cell ``uea_awr.select``: its counts, its two readers
on synthetic runs, and its runs at a tiny size on the CPU's plain tier,
with the timed path whole and broken."""
import json
import time

import pytest
import torch

import sigkernel_tpu_torch as skt
from bench_torch import harness, trace, traffic, work
from bench_torch.calibrate import readings
from sigkernel_tpu_torch.ops import cuda_gen

from conftest import ROOT, shrink

CPU = torch.device("cpu")
CELL = "uea_awr.select"
# the relative change of an altered answer
ALTER = 1e-4


def _cell(root=ROOT):
    return harness.Cell(CELL, root)


def test_pairs_and_outputs_a_call():
    c = _cell()
    # 2 transforms x 5 sigmas x (275 * 276 / 2 + 300 * 275)
    assert c.pairs() == 10 * (37_950 + 82_500) == 1_204_500
    assert c.kind.floats_out(c.mix, c.config) == 10 * (275 ** 2 + 300 * 275)
    assert c.kind.shapes(c.config) == [("at", 144, 10), ("atll", 287, 19)]


def reader(name):
    cell = harness.Cell.__new__(harness.Cell)
    cell.bench = ROOT / "bench_torch"
    return harness.Cell.reader(cell, name)


def synthetic(cell, busy_s=8.0, calls=12, library="lib.so"):
    dev = [trace.Interval("void sigkernel::band_stripe<double>(int)", 0,
                          int(busy_s * 1e9))]
    return harness.Run(cell=cell, window_s=40.0, calls=calls,
                       trace=trace.Trace(dev, []), library=library)


def test_call_roofline_counts_the_transformed_shapes():
    c = _cell()
    per_sigma = 37_950 + 82_500
    # 144 x 10: 143^2 refined (and base) cells, 144^2 point pairs at
    # 6 * 10 + 6 operations; 287 x 19: 286^2 cells, 287^2 at 6 * 19 + 6
    ops = 5 * per_sigma * ((10 + 5) * 143 ** 2 + 66 * 144 ** 2
                           + (10 + 5) * 286 ** 2 + 120 * 287 ** 2)
    least = ops / 34e12
    # the bytes read and written are far below the operations' time
    values = 575 * (144 * 10 + 287 * 19) + 2 * 5 * (275 ** 2 + 300 * 275)
    assert values * 8 / 3.35e12 < least / 100
    run = synthetic(c)
    assert reader("call_roofline.uea")(run) == pytest.approx(
        100 * 12 * least / 8.0, rel=1e-12)
    run.trace = None
    assert reader("call_roofline.uea")(run) is None
    assert work.least_seconds(0, ops, "float64") == pytest.approx(least)


def test_band_fill_reads_the_counter(monkeypatch):
    c = _cell()
    # both transforms solve the same pairs: 143 rows in 2 bands, 286 in 3
    monkeypatch.setattr(cuda_gen, "BAND_FILL",
                        {"rows": 7 * (143 + 286), "slots": 7 * (256 + 384)})
    assert reader("band_fill.uea")(synthetic(c)) == pytest.approx(
        100 * 429 / 640)
    assert reader("band_fill.uea")(synthetic(c, library=None)) is None
    monkeypatch.setattr(cuda_gen, "BAND_FILL", {"rows": 0, "slots": 0})
    assert reader("band_fill.uea")(synthetic(c)) is None
    monkeypatch.delattr(cuda_gen, "BAND_FILL")   # a program without it
    assert reader("band_fill.uea")(synthetic(c)) is None


@pytest.fixture
def uea_root(tiny_root):
    """The tiny copy, with this cell's mix at 4 train and 3 test paths."""
    p = tiny_root / "bench_torch" / "traffic" / "uea_select.json"
    mix = json.loads(p.read_text())
    mix["paths"] = {"X": 4, "T": 3}
    p.write_text(json.dumps(mix))
    return tiny_root


def test_a_tiny_run_is_correct_and_names_its_outputs(uea_root):
    c = _cell(uea_root)
    paths = traffic.draw(c.mix, c.config, 2 ** 33 + 1, 0, CPU)
    out = c.kind.run(skt, c, paths, torch.float64)
    assert {k: tuple(v.shape) for k, v in out.items()} == {
        "train_at": (5, 4, 4), "test_at": (5, 3, 4),
        "train_atll": (5, 4, 4), "test_atll": (5, 3, 4)}
    res = harness.run_cell(c, 2 ** 33 + 1, 0.2, False, CPU,
                           time.perf_counter())
    assert res["correct"] is True, res["checks"]
    assert set(res["checks"]) == set(out)
    # untraced, on the CPU: no device memory to read
    assert set(res["metrics"]) == {"setup_s", "gram_pairs_per_s"}


def test_the_control_fails_the_limits(uea_root):
    shrink(uea_root, length=64, dim=9)
    c = _cell(uea_root)
    sound, _ = readings(c, 3, torch.float64, CPU, skt)
    control, _ = readings(c, 3, torch.float32, CPU, skt)
    assert all(v <= c.limits[k] for k, v in sound.items()), sound
    assert any(v > c.limits[k] for k, v in control.items()), control


def _break(monkeypatch, fault):
    """Break the timed path underneath the kind: the transforms or the
    SVC's Grams."""
    if fault == "no_scale":
        orig = skt.transform
        monkeypatch.setattr(skt, "transform",
                            lambda p, at=False, ll=False, scale=1.0:
                            orig(p, at, ll, 1.0))
        return
    if fault == "no_time":
        orig = skt.transform
        monkeypatch.setattr(skt, "transform",
                            lambda p, at=False, ll=False, scale=1.0:
                            torch.nn.functional.pad(orig(p, False, ll, scale),
                                                    (1, 0)))
        return
    cls = skt.models.SigKernelSVC
    name = "train_gram" if fault.startswith("train") else "test_gram"
    orig = getattr(cls, name)

    def broken(self, X):
        K = orig(self, X).clone()
        if fault.endswith("answer"):
            K[-1, 0] *= 1 + ALTER
        else:                                   # a path's row left unsolved
            K[-1] = K[:-1].mean(0)
        return K

    monkeypatch.setattr(cls, name, broken)


@pytest.mark.parametrize("fault", ["no_scale", "no_time", "train_answer",
                                   "test_answer", "train_half",
                                   "test_half"])
def test_a_broken_timed_path_is_not_correct(uea_root, monkeypatch, fault):
    c = _cell(uea_root)
    _break(monkeypatch, fault)
    res = harness.run_cell(c, 9, 0.2, False, CPU, time.perf_counter())
    assert res["correct"] is False, res["checks"]
    assert any(ch["value"] is None or ch["value"] > ch["limit"]
               for ch in res["checks"].values())


def test_a_program_without_the_transforms_stops_at_the_warm_call(
        uea_root, monkeypatch):
    """The parent of this cell has no ``transform``: the run raises at once,
    before any window."""
    monkeypatch.delattr(skt, "transform")
    t = time.perf_counter()
    with pytest.raises(AttributeError):
        harness.run_cell(_cell(uea_root), 9, 30.0, False, CPU, t)
    assert time.perf_counter() - t < 30.0


@pytest.mark.parametrize("budget", [1 << 28, 40_000])
def test_the_reference_is_the_plain_grams_at_each_sigma(uea_root,
                                                        monkeypatch, budget):
    """The kind's reference, one distance pass a block for every sigma, is
    bit for bit ``reference.gram_sym`` and ``pair_values`` of each sigma's
    static kernel, in one block or (a budget of a few pairs) in many."""
    from bench_torch import reference as ref
    from bench_torch import transforms_ref

    monkeypatch.setattr(ref, "_budget", lambda device: budget)
    c = _cell(uea_root)
    paths = traffic.draw(c.mix, c.config, 77, 0, CPU)
    got = c.kind.reference(c, paths)
    for t in c.config["transforms"]:
        x = transforms_ref.transform(paths["X"], scale=0.1, **t)
        y = transforms_ref.transform(paths["T"], scale=0.1, **t)
        tag = c.kind.tag(t)
        ii = torch.arange(3).repeat_interleave(4)
        jj = torch.arange(4).repeat(3)
        for k, s in enumerate(c.config["sigmas"]):
            kern = c.static.Kernel(torch.tensor(s, dtype=torch.float64))
            assert torch.equal(got[f"train_{tag}"][k],
                               ref.gram_sym(x, kern, 1))
            assert torch.equal(got[f"test_{tag}"][k], ref.pair_values(
                y, x, ii, jj, kern, 1).reshape(3, 4))
