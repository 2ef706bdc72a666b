"""One run of one cell: set-up, the measured window, the check against the
reference, and the result line.

Everything that belongs to one cell is found by name: the cell in
``BENCHMARK.json``, its configuration's file and static kernel
(``static_kernels/<name>.py``), its traffic mix (``traffic/<mix>.json``)
and the mix's kind of call (``kinds/<kind>.py``), its limits
(``limits/<cell>.json``) and a reader for each metric the cell reports
(``metrics/<metric>.py``, a function ``read(run)`` that returns a number or
``None``, or ``SAME_AS``, the name of a metric whose reader it uses).

The outputs the check compares are a seeded sample of the window's calls,
kept as the calls finish (a reservoir of ``check_calls`` slots) and moved
to the host, so the card holds the same whatever number of calls a window
makes.

The loop is closed: one caller issues the next call after the previous one
has synchronised. Calls are started while the window's ``seconds`` have not
passed, and the window ends when the last call started has finished, so
every rate is all the work of the window over all its time.
"""
from __future__ import annotations

import contextlib
import importlib
import json
import math
import random
import subprocess
import sys
import time
from pathlib import Path

import torch

from . import named
from . import reference as ref
from . import trace as tr
from . import traffic as tf
from . import work

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

# a call index no window reaches: the warm-up call's inputs
WARM_CALL = 1 << 40


class Cell:
    """A cell's entry, configuration, mix and limits, read from ``root``."""

    def __init__(self, name, root=ROOT):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; the benchmark has "
                             f"{sorted(cells)}")
        self.name, self.entry = name, cells[name]
        configs = {c["name"]: c for c in self.spec["configs"]}
        self.config = json.loads(
            (self.root / configs[self.entry["config"]]["file"]).read_text())
        self.bench = self.root / self.spec["paths"][0]
        self.mix = json.loads(
            (self.bench / "traffic" / f"{self.entry['traffic']}.json")
            .read_text())
        self.limits = json.loads(
            (self.bench / "limits" / f"{name}.json").read_text())
        self.kind = tf.kind(self.mix["kind"], self.bench)
        self.static = ref.static_kernel(self.config["static_kernel"],
                                        self.bench)

    def metrics(self, traced):
        """The cell's metric entries: its end-to-end ones untraced, its
        per-layer ones traced."""
        group = self.spec["per_layer" if traced else "end_to_end"]
        return [m for m in group
                if self.name in m.get("workloads", [self.name])]

    def reader(self, metric):
        mod = named.load(self.bench / "metrics", metric, "metric")
        same = getattr(mod, "SAME_AS", None)
        return self.reader(same) if same else mod.read

    def pairs(self):
        return self.kind.pairs(self.mix)

    def least_seconds(self):
        """The least time of one call's mathematics on the card."""
        cfg, mix = self.config, self.mix
        L, D, f = cfg["length"], cfg["dim"], 2 ** cfg["dyadic_order"]
        grad = bool(mix.get("grad"))
        values, ops = work.call_work(
            self.pairs(), L, L, D, f, grad, sum(mix["paths"].values()),
            self.kind.floats_out(mix, cfg), self.static.point_ops(D, grad))
        return work.least_seconds(values, ops, cfg["dtype"])


class Run:
    """What a run measured, as the metric readers see it."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def launch_count():
    """Kernel launches the program has counted so far: every ``*COUNTS``
    table of its ``ops`` modules, all keys but the plain versions'."""
    import pkgutil

    import sigkernel_tpu_torch.ops as ops

    total = 0
    for info in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"{ops.__name__}.{info.name}")
        for name, table in vars(mod).items():
            if name.endswith("COUNTS") and isinstance(table, dict):
                total += sum(v for k, v in table.items() if k != "plain")
    return total


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _dtype(cfg):
    return getattr(torch, cfg["dtype"])


def power_limit():
    """The card's power limit in watts by ``nvidia-smi``, or ``None``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "--id=0"],
            capture_output=True, text=True, timeout=30).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


class Sample:
    """A uniform sample of ``k`` of the window's calls, drawn from the seed
    as the calls finish (a reservoir): call ``c``'s outputs are kept,
    moved to the host, while fewer than ``k`` are, and past that take a
    slot drawn from ``c + 1`` if it is one of the ``k``."""

    def __init__(self, k, seed):
        self.k, self.rng, self.kept = k, random.Random(seed), []

    def offer(self, call, out):
        slot = (len(self.kept) if call < self.k
                else self.rng.randrange(call + 1))
        if slot < self.k:
            host = {n: v.detach().to("cpu", copy=True) for n, v in out.items()}
            if slot == len(self.kept):
                self.kept.append((call, host))
            else:
                self.kept[slot] = (call, host)


def check(cell, seed, kept, device):
    """Compare the sampled calls ``kept`` (``(call, outputs)``) with the
    reference: the largest of each number over the sample."""
    nums = {}
    for c, out in sorted(kept, key=lambda co: co[0]):
        paths = tf.draw(cell.mix, cell.config, seed, c, device)
        want = cell.kind.reference(cell, paths)
        for name, v in tf.compare(out, want).items():
            nums[name] = max(nums.get(name, 0.0), v)
    return nums


def run_cell(cell, seed, seconds, traced, device, t_start, parts=None):
    """One run; returns the result line's object. ``parts`` holds the
    seconds of set-up's earlier parts; the result line gives every part
    (``setup_parts_s``)."""
    t = time.perf_counter()
    parts = dict(parts or {})
    parts["other"] = t - t_start - sum(parts.values())
    import sigkernel_tpu_torch as skt

    t = _part(parts, "import", t)
    if device.type == "cuda":
        from sigkernel_tpu_torch.ops import _build

        torch.cuda.init()
        t = _part(parts, "context", t)
        _build.library()
        t = _part(parts, "library", t)
    dtype, cfg, mix = _dtype(cell.config), cell.config, cell.mix
    with torch.no_grad():
        warm = tf.draw(mix, cfg, seed, WARM_CALL, device)
    cell.kind.run(skt, cell, warm, dtype)
    del warm
    _sync(device)
    _part(parts, "warm_call", t)
    cuda = device.type == "cuda"
    peak_setup = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    launches0 = launch_count()
    sample = Sample(mix["check_calls"], seed)
    calls, call_s, failed, error = 0, [], 0, None
    with tr.profiler() if traced else contextlib.nullcontext() as prof:
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        while time.perf_counter() - t0 < seconds:
            with torch.no_grad():
                paths = tf.draw(mix, cfg, seed, calls, device)
            a = time.perf_counter()
            try:
                out = cell.kind.run(skt, cell, paths, dtype)
                _sync(device)
            except (RuntimeError, ValueError) as e:
                failed, error = 1, e
                break
            call_s.append(time.perf_counter() - a)
            sample.offer(calls, out)
            calls += 1
            del paths, out
        window_s = time.perf_counter() - t0
    launches = launch_count() - launches0
    peak_window = torch.cuda.max_memory_allocated(device) if cuda else 0
    trace = tr.from_profiler(prof) if prof is not None else None
    del prof
    if error is not None:
        print(f"call {calls} failed: {error!r}", file=sys.stderr)
    attempted = calls + failed

    run = Run(cell=cell, setup_s=setup_s, window_s=window_s, call_s=call_s,
              calls=calls, pairs=cell.pairs() * calls,
              least_s=cell.least_seconds() * calls,
              peak_window_bytes=peak_window, launches=launches, trace=trace,
              library=_library_path(device))
    metrics = {}
    for m in cell.metrics(traced):
        v = cell.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.entry["chips"],
           "memory_peak_bytes": max(peak_setup, peak_window),
           "power_limit_w": power_limit() if cuda else None}
    result = {"attempted": attempted, "failed": failed, "metrics": metrics,
              "device": dev, "setup_parts_s": parts}
    if trace is not None:
        dev["busy_s"] = tr.busy_seconds(trace)
        dev["window_s"] = window_s
        result["breakdown"] = {"device_ops": tr.device_ops(trace),
                               "idle_gaps": tr.idle_gaps(trace)}
    del trace, run
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    nums = check(cell, seed, sample.kept, device) if calls else {}
    print(f"reference: {len(sample.kept)} calls, "
          f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    checks = {k: {"value": nums.get(k, math.inf), "limit": cell.limits[k]}
              for k in sorted(set(nums) | set(cell.limits))}
    correct = (failed == 0 and calls > 0 and all(
        c["value"] <= c["limit"] for c in checks.values()))
    for c in checks.values():   # a number that is missing or not finite
        if not math.isfinite(c["value"]):
            c["value"] = None
    return {"correct": correct, **result, "checks": checks}


def _part(parts, name, t):
    """Put the seconds since ``t`` under ``name``; returns the clock."""
    now = time.perf_counter()
    parts[name] = now - t
    return now


def _library_path(device):
    if device.type != "cuda":
        return None
    from sigkernel_tpu_torch.ops import _build

    return _build.library_path()
