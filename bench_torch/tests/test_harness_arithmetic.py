"""The yardstick's arithmetic, the traffic generator's counts and draws, and
the trace reduction, on synthetic inputs."""
import json
import math

import pytest
import torch

from bench_torch import harness, reference, trace, traffic, work

from conftest import ROOT


def mix(name):
    return json.loads((ROOT / "bench_torch" / "traffic" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("name,pairs", [("lincomb_train", 10_000),
                                        ("scoring_train", 560),
                                        ("gram_sym", 5_050),
                                        ("chsic", 3_825)])
def test_pairs_a_call(name, pairs):
    m = mix(name)
    assert traffic.kind(m["kind"]).pairs(m) == pairs


def test_draws_repeat_by_seed_and_differ_by_call():
    m, cfg = mix("chsic"), {"length": 7, "dim": 2}
    a = traffic.draw(m, cfg, 2 ** 33 + 5, 3, torch.device("cpu"))
    b = traffic.draw(m, cfg, 2 ** 33 + 5, 3, torch.device("cpu"))
    c = traffic.draw(m, cfg, 2 ** 33 + 5, 4, torch.device("cpu"))
    assert list(a) == ["X", "Y", "Z"]
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["X"], c["X"])
    assert a["X"].shape == (50, 7, 2) and a["X"].dtype == torch.float64


def test_compare_reads_missing_wrong_shape_and_nan_as_infinite():
    f64 = torch.float64
    want = {"value": torch.tensor(2.0, dtype=f64), "dX": torch.ones(2, 3)}
    got = {"value": torch.tensor(2.0 + 2e-9, dtype=f64)}
    nums = traffic.compare(got, want)
    assert nums["value"] == pytest.approx(1e-9) and nums["dX"] == math.inf
    assert traffic.compare({"dX": torch.ones(3, 2)}, want)["dX"] == math.inf
    bad = {"dX": torch.full((2, 3), float("nan"))}
    assert traffic.compare(bad, want)["dX"] == math.inf


def test_the_call_work_of_the_north_star():
    # 10,000 pairs, len 1024, dim 3, dyadic 1, values and gradients
    rbf = reference.static_kernel("RBFKernel")
    values, ops = work.call_work(10_000, 1024, 1024, 3, 2, True, 200,
                                 1 + 2 * 100 * 1024 * 3 + 1,
                                 rbf.point_ops(3, True))
    cells, base, pts = 2046 ** 2, 1023 ** 2, 1024 ** 2
    assert ops == 10_000 * (22 * cells + 5 * base + 24 * pts + 43 * pts)
    assert values == 200 * 1024 * 3 + 614_402
    least = work.least_seconds(values, ops, "float64")
    assert least == pytest.approx(ops / 34e12)
    assert 0.04 < least < 0.06
    assert work.pair_ops(1024, 1024, 2, False, rbf.point_ops(3, False)) == (
        10 * cells + 5 * base + 24 * pts)
    lin = reference.static_kernel("LinearKernel")
    assert work.pair_ops(1024, 1024, 2, True, lin.point_ops(3, True)) == (
        22 * cells + 5 * base + (7 + 14) * pts)


def test_the_floats_a_call_writes():
    cfg = {"length": 1024, "dim": 3}
    m = mix("lincomb_train")
    assert traffic.kind("lincomb").floats_out(m, cfg) == 1 + 2 * 100 * 1024 * 3 + 1
    m = mix("gram_sym")
    assert traffic.kind("gram_sym").floats_out(m, cfg) == 100 * 100


def iv(name, s, e):
    return trace.Interval(name, s, e)


def test_busy_time_is_the_union_of_device_intervals():
    t = trace.Trace([iv("a", 0, 10), iv("b", 5, 20), iv("c", 30, 40)], [])
    assert trace.merged(t.device) == [[0, 20], [30, 40]]
    assert trace.busy_seconds(t) == pytest.approx(30e-9)


def test_idle_gaps_go_to_the_innermost_host_span():
    dev = [iv("k1", 0, 10), iv("k2", 20, 30), iv("k1", 40, 50),
           iv("k2", 100, 110)]
    host = [iv("bench.call", 0, 120), iv("aten::item", 12, 18),
            iv("cudaStreamSynchronize", 13, 17), iv("aten::cat", 55, 95)]
    t = trace.Trace(dev, host)
    gaps = trace.idle_gaps(t)
    assert [n for n, _ in gaps] == ["aten::cat", "cudaStreamSynchronize",
                                    "bench.call"]
    assert [s for _, s in gaps] == pytest.approx([50e-9, 10e-9, 10e-9])
    ops = trace.device_ops(t)
    assert [n for n, _ in ops] == ["k1", "k2"]
    assert [s for _, s in ops] == pytest.approx([20e-9, 20e-9])


def test_library_kernels_are_named_from_the_built_file(tmp_path):
    lib = tmp_path / "lib.so"
    lib.write_bytes(b"\x00_ZN9sigkernel11band_stripeIdLi0ELi1ENS_9RbfSourceIdLi3E"
                    b"EEEvT2_\x00junk\x00_Z17rbf_dd_vjp_kernelIdEvPKT_\x00"
                    b"_ZN12_GLOBAL__N_14scanEv\x00_ZNSt6vectorIiED2Ev\x00")
    names = trace.library_names(lib)
    assert {"sigkernel::band_stripe", "rbf_dd_vjp_kernel",
            "(anonymous namespace)::scan"} <= names
    k = ("void sigkernel::band_stripe<double, 0, 1, sigkernel::RbfSource"
         "<double, 3> >(sigkernel::RbfSource<double, 3>, double*)")
    torch_k = "void at::native::vectorized_elementwise_kernel<4, X>(int, X)"
    assert trace.function_name(k) == "sigkernel::band_stripe"
    t = trace.Trace([iv(k, 0, 30), iv(torch_k, 40, 50),
                     iv("Memcpy DtoH (Device -> Pinned)", 60, 70)], [])
    assert trace.library_seconds(t, names) == pytest.approx((30e-9, 50e-9))


def test_launch_count_reads_every_counter_table():
    from sigkernel_tpu_torch.ops import cuda_gen, incvjp

    before = harness.launch_count()
    cuda_gen.COUNTS["float64"] += 2
    incvjp.COUNTS["plain"] += 5       # a plain version: no launch
    try:
        assert harness.launch_count() == before + 2
    finally:
        cuda_gen.COUNTS["float64"] -= 2
        incvjp.COUNTS["plain"] -= 5


@pytest.mark.parametrize("calls", [2, 5, 200])
def test_the_check_sample_is_seeded_bounded_and_on_the_host(calls):
    def sample(seed):
        s = harness.Sample(5, seed)
        for c in range(calls):
            s.offer(c, {"v": torch.full((2,), float(c))})
            assert len(s.kept) == min(c + 1, 5)
        return s.kept

    kept = sample(2 ** 33 + 1)
    picked = [c for c, _ in kept]
    assert len(set(picked)) == min(calls, 5)
    assert all(float(out["v"][0]) == c and out["v"].device.type == "cpu"
               for c, out in kept)
    assert picked == [c for c, _ in sample(2 ** 33 + 1)]
    if calls == 200:    # the reservoir reaches past the first calls
        assert max(picked) >= 5
        assert picked != [c for c, _ in sample(2 ** 33 + 2)]
