"""Whole runs on the CPU at a tiny size: every cell's traffic, the result
line's shape, discovery of new cells, configurations and metrics by name,
and the refusals (no card; no program beside the benchmark)."""
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from bench_torch import harness

from conftest import CELLS, ROOT

CPU = torch.device("cpu")


def run(root, cell, traced=False, seconds=0.3, seed=2 ** 33 + 11):
    return harness.run_cell(harness.Cell(cell, root), seed, seconds, traced,
                            CPU, time.perf_counter())


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_runs_and_is_correct(tiny_root, cell, traced):
    res = run(tiny_root, cell, traced)
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    for c in res["checks"].values():
        assert 0 <= c["value"] <= c["limit"]
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    group = spec["per_layer" if traced else "end_to_end"]
    want = {m["name"] for m in group if cell in m.get("workloads", [cell])}
    # on the CPU the device's readings find nothing to read
    assert set(res["metrics"]) <= want
    if not traced:
        assert "setup_s" in res["metrics"]
        assert any(k.endswith("pairs_per_s") for k in res["metrics"])
    json.loads(json.dumps(res))


def test_the_same_seed_draws_the_same_calls(tiny_root):
    cell = harness.Cell("northstar.gram", tiny_root)
    a = [harness.tf.draw(cell.mix, cell.config, 77, c, CPU) for c in range(3)]
    b = [harness.tf.draw(cell.mix, cell.config, 77, c, CPU) for c in range(3)]
    assert all(torch.equal(x["X"], y["X"]) for x, y in zip(a, b))


def test_a_new_cell_config_mix_and_metric_are_found_by_name(tiny_root):
    bench = tiny_root / "bench_torch"
    cfg = json.loads((bench / "configs" / "northstar_rbf.json").read_text())
    cfg.update(sigma=0.5, dyadic_order=0, length=6)
    (bench / "configs" / "wide_rbf.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "gram_pairs.json").write_text(json.dumps(
        {"kind": "gram_sym", "paths": {"X": 3}, "max_batch": 2,
         "check_calls": 1}))
    (bench / "limits" / "wide.gram.json").write_text('{"gram": 1e-9}')
    (bench / "metrics" / "calls_seen.py").write_text(
        "def read(run):\n    return float(run.calls)\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "wide_rbf", "source": "test",
                            "file": "bench_torch/configs/wide_rbf.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "wide.gram", "config": "wide_rbf",
                              "traffic": "gram_pairs", "chips": 1,
                              "why": "test"})
    spec["end_to_end"].append({"name": "calls_seen", "unit": "calls",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["wide.gram"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    res = run(tiny_root, "wide.gram")
    assert res["correct"] is True
    assert res["metrics"]["calls_seen"]["value"] == res["attempted"]
    assert set(res["metrics"]) == {"setup_s", "calls_seen"}


GRAM_XY = '''"""compute_Gram(X, Y): every pair of X and Y."""
from bench_torch import reference as ref
from bench_torch import traffic as tf


def pairs(mix):
    return mix["paths"]["X"] * mix["paths"]["Y"]


def floats_out(mix, cfg):
    return pairs(mix)


def run(skt, cell, paths, dtype):
    x, p = tf.leaves(cell, paths, dtype)
    sk = skt.SigKernel(tf.program_kernel(skt, cell, p),
                       cell.config["dyadic_order"])
    return {"gram": sk.compute_Gram(x["X"], x["Y"])}


def reference(cell, paths):
    X, Y = paths["X"], paths["Y"]
    n, m = X.shape[0], Y.shape[0]
    ii = ref.torch.arange(n).repeat_interleave(m)
    jj = ref.torch.arange(m).repeat(n)
    v = ref.pair_values(X, Y, ii, jj, tf.reference_kernel(cell, paths),
                        2 ** cell.config["dyadic_order"])
    return {"gram": v.reshape(n, m)}
'''


def _add_cell(root, name, config, cfg, mix_name, mix, limits):
    """Add a cell, its configuration and its mix as new files and entries."""
    bench = root / "bench_torch"
    (bench / "configs" / f"{config}.json").write_text(json.dumps(cfg))
    (bench / "traffic" / f"{mix_name}.json").write_text(json.dumps(mix))
    (bench / "limits" / f"{name}.json").write_text(json.dumps(limits))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": config, "source": "test",
                            "file": f"bench_torch/configs/{config}.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": name, "config": config,
                              "traffic": mix_name, "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


def test_a_new_kind_of_call_is_found_by_name(tiny_root):
    (tiny_root / "bench_torch" / "kinds" / "gram_xy.py").write_text(GRAM_XY)
    cfg = json.loads((tiny_root / "bench_torch" / "configs" /
                      "longpath_rbf.json").read_text())
    _add_cell(tiny_root, "xy.gram", "xy_rbf", cfg, "gram_xy",
              {"kind": "gram_xy", "paths": {"X": 3, "Y": 2},
               "check_calls": 2}, {"gram": 1e-9})
    c = harness.Cell("xy.gram", tiny_root)
    assert c.pairs() == 6
    assert c.least_seconds() > 0
    res = run(tiny_root, "xy.gram")
    assert res["correct"] is True, res["checks"]
    assert list(res["checks"]) == ["gram"]


def test_a_linear_kernel_configuration_needs_no_new_code(tiny_root):
    cfg = json.loads((tiny_root / "bench_torch" / "configs" /
                      "northstar_rbf.json").read_text())
    del cfg["sigma"]
    cfg.update(static_kernel="LinearKernel", scale=0.9)
    _add_cell(tiny_root, "lin.train", "northstar_linear", cfg, "lin_train",
              {"kind": "lincomb", "paths": {"X": 3, "Y": 3},
               "grad": ["X", "Y", "scale"], "pair_chunk": 4,
               "check_calls": 2},
              {"value": 1e-9, "dX": 1e-9, "dY": 1e-9, "dscale": 1e-9})
    res = run(tiny_root, "lin.train")
    assert res["correct"] is True, res["checks"]
    assert set(res["checks"]) == {"value", "dX", "dY", "dscale"}


@pytest.mark.parametrize("key,value,what", [
    ("static_kernel", "CubicKernel", "static kernel"),
    ("kind", "sig_mmd", "kind of call")])
def test_an_unknown_name_is_refused(tiny_root, key, value, what):
    bench = tiny_root / "bench_torch"
    path = bench / ("configs/northstar_rbf.json" if key == "static_kernel"
                    else "traffic/gram_sym.json")
    d = json.loads(path.read_text())
    d[key] = value
    path.write_text(json.dumps(d))
    with pytest.raises(ValueError, match=f"unknown {what} '{value}'"):
        harness.Cell("northstar.gram", tiny_root)


def _run_py(root, *extra):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run(
        [sys.executable, "bench_torch/run.py", "--workload", "northstar.gram",
         "--seed", str(2 ** 34 + 3), "--seconds", "1", "--trace", "0",
         *extra], cwd=root, env=env, capture_output=True, text=True,
        timeout=300)


def test_no_card_means_no_result(tiny_root):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    p = _run_py(ROOT)
    assert p.returncode != 0 and p.stdout == ""
    assert "needs 1 CUDA card" in p.stderr


def test_no_program_beside_the_benchmark_means_no_result(tiny_root):
    # the checkout holds only BENCHMARK.json and the benchmark's files
    p = _run_py(tiny_root)
    assert p.returncode != 0 and p.stdout == ""


def test_nothing_under_the_benchmark_imports_jax(tiny_root):
    code = (
        "import sys, time, torch; sys.path.insert(0, %r);"
        "from bench_torch import harness, calibrate, run;"
        "c = harness.Cell('longpath.scoring', %r);"
        "r = harness.run_cell(c, 5, 0.2, True, torch.device('cpu'),"
        " time.perf_counter());"
        "[c.reader(m['name']) for m in c.spec['end_to_end'] + c.spec['per_layer']];"
        "ref = 'sigkernel' + '_tpu';"
        "bad = [m for m in sys.modules if m in ('jax', ref)"
        " or m.startswith(('jax.', ref + '.'))];"
        "assert r['correct'] and not bad, bad" % (str(ROOT), str(tiny_root)))
    env = dict(os.environ, PYTHONPATH="")
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=300)
    forbidden = ("import " + "jax", "from " + "jax", "sigkernel_tpu" + ".",
                 "bench" + ".py", "BENCH" + "_", "bench" + "marks/")
    for path in (ROOT / "bench_torch").rglob("*.py"):
        text = path.read_text()
        for word in forbidden:
            assert word not in text, (path, word)
