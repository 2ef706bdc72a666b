"""The readers of the program's spans (``spans.py``, ``syncs.*``,
``idle_wrappers.*``, ``idle_estimators.*``) on synthetic traces with known
gaps and nested spans."""
import pytest

from bench_torch import harness, spans, trace

from conftest import ROOT

S = 10 ** 9   # ns a second
LAYERS = ["syncs", "idle_wrappers", "idle_estimators"]


def reader(name):
    cell = harness.Cell.__new__(harness.Cell)
    cell.bench = ROOT / "bench_torch"
    return harness.Cell.reader(cell, name)


def iv(name, start, end):
    return trace.Interval(name, int(start * S), int(end * S))


def synthetic(host=None, traced=True, calls=2):
    """Device busy 0-1, 2-3, 4-5, 6-7, 8-9 s in a 10 s window: four gaps of
    1 s, at whose middles (1.5, 3.5, 5.5, 7.5 s) the host is in a kernel
    wrapper, an estimator's loop, a host read, and between calls."""
    dev = [iv("void sigkernel::band_stripe<double>(int)", t, t + 1)
           for t in (0, 2, 4, 6, 8)]
    if host is None:
        host = [iv("sk.est.sig_gram_lincomb", 0, 7.2),
                iv("sk.est.chunk", 0.5, 4.5),
                iv("sk.op.rbf_gen_stack", 1.2, 1.8),     # gap 1
                iv("aten::empty", 3.3, 3.7),             # gap 2: the chunk's
                iv("sk.est.chunk", 5.2, 7.0),
                iv("sk.op.adjoint_collapse_gen", 5.3, 5.9),
                iv("sk.sync.sigma", 5.4, 5.6),           # gap 3
                iv("sk.sync.index_bounds", 5.7, 5.8),
                iv("sk.sync.sigma", 6.1, 6.2),
                iv("aten::copy_", 7.4, 7.6)]             # gap 4: no sk. span
    return harness.Run(window_s=10.0, calls=calls,
                       trace=trace.Trace(dev, host) if traced else None)


def test_program_idle_charges_each_gap_to_its_innermost_span():
    t = synthetic().trace
    assert spans.program_idle(t, ("sk.op.", "sk.sync.")) == pytest.approx(2.0)
    assert spans.program_idle(t, ("sk.est.", "sk.grid")) == pytest.approx(1.0)
    assert spans.program_idle(t, ("sk.",)) == pytest.approx(3.0)
    assert spans.program_idle(t, ("sk.sync.",)) == pytest.approx(1.0)


def test_the_latest_started_span_wins_on_any_thread():
    """A gap at 1.5 s: a wrapper open on one thread since 0.2 s, a chunk of
    the backward's thread since 1.1 s, and a host read that ended at 1.4
    s before the middle."""
    host = [iv("sk.op.rbf_dd_vjp", 0.2, 9.0),
            iv("sk.est.chunk", 1.1, 1.9),
            iv("sk.sync.sigma", 1.3, 1.4),
            iv("sk.grid", 3.0, 3.6)]
    t = synthetic(host).trace
    assert spans.program_idle(t, ("sk.est.",)) == pytest.approx(1.0)
    # gap 2 goes to sk.grid, gaps 3 and 4 to the wrapper
    assert spans.program_idle(t, ("sk.grid",)) == pytest.approx(1.0)
    assert spans.program_idle(t, ("sk.op.",)) == pytest.approx(2.0)
    assert spans.program_idle(t, ("sk.sync.",)) == 0.0


@pytest.mark.parametrize("k", ["train", "gram"])
def test_readers_are_exact(k):
    run = synthetic()
    assert reader(f"syncs.{k}")(run) == 1.5
    assert reader(f"idle_wrappers.{k}")(run) == pytest.approx(20.0)
    assert reader(f"idle_estimators.{k}")(run) == pytest.approx(10.0)


@pytest.mark.parametrize("k", ["train", "gram"])
def test_the_two_idle_layers_sum_to_at_most_the_device_idle(k):
    """4 s of the 5 s idle lie in gaps, the window's edges outside them;
    the gap with no span counts for neither layer."""
    run = synthetic()
    idle = reader(f"idle.{k}")(run)
    both = (reader(f"idle_wrappers.{k}")(run)
            + reader(f"idle_estimators.{k}")(run))
    assert idle == pytest.approx(50.0)
    assert both == pytest.approx(30.0) and both <= idle


@pytest.mark.parametrize("metric", [f"{m}.{k}" for m in LAYERS
                                    for k in ("train", "gram")])
def test_readers_find_nothing_to_read(metric):
    """Untraced; a program that opens no ``sk.`` span (the harness on an
    older program); a trace with no device interval (the CPU)."""
    read = reader(metric)
    assert read(synthetic(traced=False)) is None
    assert read(synthetic(host=[iv("aten::mm", 1.2, 1.8)])) is None
    if not metric.startswith("syncs"):
        run = synthetic()
        run.trace = trace.Trace([], run.trace.host)
        assert read(run) is None


def test_a_call_with_no_host_read_reads_zero_syncs():
    run = synthetic(host=[iv("sk.est.sig_scoring_rule", 0, 9)])
    assert reader("syncs.train")(run) == 0.0
    assert reader("idle_wrappers.train")(run) == 0.0
    assert reader("idle_estimators.train")(run) == pytest.approx(40.0)
