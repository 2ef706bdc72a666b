"""Run one cell of the benchmark once and print its result line.

    python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells, configurations, traffic mixes, limits and metric readers are
found by name from ``BENCHMARK.json`` at the root of the checkout (see
``harness.py``). The run needs a CUDA card: without one, or with fewer
than the cell asks for, it exits with code 2 and prints no result. The
last line of standard output is the result's JSON object; the last lines of
standard error give each number compared beside its limit.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache inside the checkout, at fixed paths
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda"}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
    sys.path.insert(0, str(ROOT))
    import torch

    from bench_torch import harness

    parts = {"import_torch": time.perf_counter() - T_START}
    cell = harness.Cell(args.workload, ROOT)
    chips = cell.entry["chips"]
    t = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    parts["cuda_check"] = time.perf_counter() - t
    torch.set_num_threads(4)   # few host threads: steadier runs
    res = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), T_START, parts)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
