"""Each metric reader on a synthetic run."""
import pytest

from bench_torch import harness, trace

from conftest import ROOT


def reader(name):
    cell = harness.Cell.__new__(harness.Cell)
    cell.bench = ROOT / "bench_torch"
    return harness.Cell.reader(cell, name)


def synthetic(traced=True, library="lib.so", calls=25):
    dev = [trace.Interval("void sigkernel::band_stripe<double>(int)", 0,
                          6 * 10 ** 9),
           trace.Interval("void at::native::fill<double>(int)", 7 * 10 ** 9,
                          9 * 10 ** 9)]
    return harness.Run(
        setup_s=9.5, window_s=10.0, call_s=[0.4 + 0.01 * i for i in range(calls)],
        calls=calls, pairs=5_050 * calls, least_s=0.4, peak_window_bytes=2 ** 31,
        launches=3 * calls, trace=trace.Trace(dev, []) if traced else None,
        library=library)


def test_end_to_end_readers():
    run = synthetic(traced=False)
    assert reader("setup_s")(run) == 9.5
    assert reader("train_pairs_per_s")(run) == pytest.approx(12_625.0)
    assert reader("gram_pairs_per_s")(run) == pytest.approx(12_625.0)
    # the inclusive 95th percentile of 0.40 .. 0.64 s: 0.40 + 0.95 * 0.24
    assert reader("call_ms_p95")(run) == pytest.approx(628.0)
    assert reader("peak_mem_gib")(run) == 2.0
    assert reader("call_ms_p95")(synthetic(calls=19)) is None


@pytest.mark.parametrize("k", ["train", "gram"])
def test_per_layer_readers(k, monkeypatch):
    run = synthetic()
    assert reader(f"call_roofline.{k}")(run) == pytest.approx(100 * 0.4 / 8.0)
    assert reader(f"idle.{k}")(run) == pytest.approx(20.0)
    assert reader(f"launches.{k}")(run) == 3.0
    untraced = synthetic(traced=False)
    assert reader(f"call_roofline.{k}")(untraced) is None
    assert reader(f"idle.{k}")(untraced) is None
    assert reader(f"launches.{k}")(synthetic(library=None)) is None


def test_torch_share(monkeypatch):
    monkeypatch.setattr(trace, "library_names",
                        lambda path: {"sigkernel::band_stripe"})
    assert reader("torch_share.train")(synthetic()) == pytest.approx(25.0)
    assert reader("torch_share.train")(synthetic(library=None)) is None
