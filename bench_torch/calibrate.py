"""The readings a cell's limits are set from, in one process on the card.

    python3 bench_torch/calibrate.py --workload <cell> --seeds 1 2 ... \\
        --control-seeds 101 102 103

For each of ``--seeds`` it runs one call of the cell's traffic through the
program, at the cell's own size, and compares it with the reference, as a
run compares the calls it samples; for each of ``--control-seeds`` it does
the same with the control: the program's float32 path, the precision below
the configuration's float64 (float32 paths and ``sigma``). One JSON line
per seed, then the largest reading of the program and the smallest of the
control for each number. The benchmark's own runs do not run the control.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seed, dtype, device, skt):
    """The numbers compared for one call drawn from ``seed``, the program
    run in ``dtype``."""
    import torch

    from bench_torch import traffic as tf

    paths = tf.draw(cell.mix, cell.config, seed, 0, device)
    out = cell.kind.run(skt, cell, paths, dtype)
    out = {k: v.detach() for k, v in out.items()}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t = time.perf_counter()
    want = cell.kind.reference(cell, paths)
    return tf.compare(out, want), time.perf_counter() - t


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    import sigkernel_tpu_torch as skt
    from bench_torch import harness

    cell = harness.Cell(args.workload, ROOT)
    device = torch.device("cuda")
    program = getattr(torch, cell.config["dtype"])
    lower, upper = {}, {}
    for seeds, dtype, acc, pick in ((args.seeds, program, lower, max),
                                    (args.control_seeds, torch.float32,
                                     upper, min)):
        for seed in seeds:
            nums, sec = readings(cell, seed, dtype, device, skt)
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "control": dtype != program, "numbers": nums,
                              "reference_s": sec}), flush=True)
            for k, v in nums.items():
                acc[k] = pick(acc.get(k, v), v)
    print(json.dumps({"workload": cell.name, "lower": lower,
                      "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
