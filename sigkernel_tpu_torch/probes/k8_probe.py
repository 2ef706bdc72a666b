"""How K8's band kernel (``csrc/band_sweep.cuh``, kBandCkpt) schedules its
recompute of the forward values, measured on a CUDA card.

Each warp walks the windows of W forward diagonals downward; for each it
loads the stored pair from the sparse stack and recomputes the other W - 2
diagonals at its 32 rows and its halo. Two schedules (``kCkptInterleave``):
interleaved, the next window prepared one unit a step while the walk
consumes the current one, or recompute-then-consume, each window prepared
all at once when the walk enters it. The checkout's kernel (``chosen``)
interleaves in float and not in double. This builds more libraries from
patched copies of ``csrc/`` and times them against the checkout's on the
same inputs:

- ``interleave``: both dtypes interleaved;
- ``consume``: both dtypes recompute-then-consume.

The order is each variant once, then each again in reverse (CUDA events,
the mean of 5 launches after a warm-up each), and the outputs must be equal
bit for bit: K8 at ``chip_smoke.py``'s timed shape (128 pairs of length
1024, dim 3, dyadic 1) and at phase 12's (128 pairs of length 1024, dim 5,
dyadic 2), both dtypes. It also prints each library's build time and the
registers and spills that ptxas reports for K8's band instances at f = 2
and 4.

``--parent DIR`` (a checkout of another commit, unpacked with ``git
archive``) first times K2-sparse and K8 at both shapes in both dtypes for
the two checkouts, each in a process of its own, in the order parent,
this, this, parent; then ``--kernels-only`` stops there.

Run from the repository root on a machine with a CUDA card::

    python3 sigkernel_tpu_torch/probes/k8_probe.py [--parent DIR]
        [--kernels-only]
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]  # the checkout holding this file
sys.path.insert(0, str(Path(__file__).resolve().parent))
import k3_probe  # noqa: E402  (card, make_paths, event_ms, patched)

DEVICE = "cuda"
PAIRS, LENGTH = 128, 1024
SHAPES = {"timed": (3, 1), "phase 12": (5, 2)}  # name: (dim, dyadic)

_RULE = r"constexpr bool kCkptInterleave = sizeof\(T\) == 4;"
VARIANTS = {
    "chosen": [],
    "interleave": [("band_sweep.cuh", _RULE,
                    "constexpr bool kCkptInterleave = true;", 1)],
    "consume": [("band_sweep.cuh", _RULE,
                 "constexpr bool kCkptInterleave = false;", 1)],
}
# the instances whose registers are printed: (dtype, f)
_SHOWN = [("d", 2), ("f", 2), ("d", 4), ("f", 4)]


def libraries(_build):
    """``{variant: (library, build seconds, nvcc.log path)}``."""
    src, libs = _build._CSRC, {}
    try:
        for name, patches in VARIANTS.items():
            _build._CSRC = (k3_probe.patched(_build, src, f"k8_{name}",
                                             patches) if patches else src)
            _build._lib, _build.build_seconds = None, None
            lib = _build.library()
            libs[name] = (lib, _build.build_seconds,
                          _build.library_path().parent / "nvcc.log")
    finally:
        _build._CSRC = src
        _build._lib = libs["chosen"][0] if "chosen" in libs else None
    return libs


def registers(log: Path):
    """``[(dtype, f, registers, spills)]`` of the ``_SHOWN`` instances of
    band_stripe in kBandCkpt mode in a ptxas report."""
    lines = log.read_text().splitlines() if log.exists() else []
    key, spills, out = None, "", []
    for line in lines:
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"band_stripeI([fd])Li3ELi(\d+)E", m.group(1))
            key = k and (k.group(1), int(k.group(2)))
            key = key if key in _SHOWN else None
            spills = ""
        elif key is None:
            continue
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            out.append((key[0], key[1], regs, spills))
    return out


def grids(torch):
    """``{(shape, dtype): (increment grid, dyadic)}`` at both shapes."""
    import sigkernel_tpu_torch as skt
    from sigkernel_tpu_torch.utils import double_difference

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    out = {}
    for shape, (dim, dyadic) in SHAPES.items():
        X64 = k3_probe.make_paths(torch, gen, PAIRS, LENGTH, dim,
                                  torch.float64)
        Y64 = k3_probe.make_paths(torch, gen, PAIRS, LENGTH, dim,
                                  torch.float64)
        for dtype in (torch.float32, torch.float64):
            out[(shape, dtype)] = (double_difference(
                skt.RBFKernel(1.0).batch_kernel(X64.to(dtype), Y64.to(dtype))
            ).contiguous(), dyadic)
    return out


def time_kernels(torch) -> dict:
    """``{kernel shape dtype: ms}`` of K2-sparse and K8 at both shapes,
    with the package on ``sys.path``; and the library's build seconds
    (None if it was built already)."""
    from sigkernel_tpu_torch.ops import _build, cuda_solver

    _build.library()
    out = {"build_s": _build.build_seconds}
    for (shape, dtype), (inc, dy) in grids(torch).items():
        name = f"{shape} {str(dtype)[6:]}"
        out[f"K2-sparse {name}"] = k3_probe.event_ms(
            torch, lambda: cuda_solver.inc_solve_sparse(inc, dy))
        _, sparse = cuda_solver.inc_solve_sparse(inc, dy)
        out[f"K8 {name}"] = k3_probe.event_ms(
            torch, lambda: cuda_solver.inc_adjoint_ckpt(inc, sparse, dy))
        del sparse
        torch.cuda.empty_cache()
    return out


def compare(parent: str, where: str) -> None:
    """:func:`time_kernels` of the checkout under ``parent`` and of this
    one, each in a process of its own, parent, this, this, parent."""
    runs = {"parent": [], "this": []}
    for who in ("parent", "this", "this", "parent"):
        root = parent if who == "parent" else str(HERE)
        res = subprocess.run([sys.executable, __file__, "--time-kernels",
                              root], capture_output=True, text=True,
                             check=True)
        runs[who].append(json.loads(res.stdout.strip().splitlines()[-1]))
    for who, (first, _) in runs.items():
        sec = first["build_s"]
        built = f"{sec:.1f} s" if sec is not None else "cached"
        print(f"[k8] {who}: library built in {built}")
    for key in runs["this"][0]:
        if key == "build_s":
            continue
        a, b = ([r[key] for r in runs[w]] for w in ("parent", "this"))
        print(f"[k8] {key} ({PAIRS} pairs, len {LENGTH}): parent "
              f"{a[0]:.3f} / {a[1]:.3f} ms, this {b[0]:.3f} / {b[1]:.3f} "
              f"ms, best this / best parent {min(b) / min(a):.3f} ({where})")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="a checkout to time K2-sparse and "
                        "K8 against first")
    parser.add_argument("--kernels-only", action="store_true",
                        help="stop after the comparison with --parent")
    parser.add_argument("--time-kernels", metavar="ROOT",
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    sys.path.insert(0, args.time_kernels or str(HERE))
    import torch

    if not torch.cuda.is_available():
        print("k8_probe: no CUDA device", file=sys.stderr)
        return 1
    if args.time_kernels:
        print(json.dumps(time_kernels(torch)))
        return 0
    where = k3_probe.card()
    if args.parent:
        compare(args.parent, where)
        if args.kernels_only:
            return 0
    from sigkernel_tpu_torch.ops import _build, cuda_solver

    libs = libraries(_build)
    for name, (_, sec, log) in libs.items():
        built = f"{sec:.1f} s" if sec is not None else "cached"
        print(f"[k8] {name}: library built in {built}")
        for dt, f, n, spill in registers(log):
            print(f"[k8] {name}: band_stripe<{dt}, kBandCkpt, {f}, "
                  f"CkptSource>: {n} registers, {spill}")
    order = list(VARIANTS) + list(VARIANTS)[::-1]
    ok = True
    for (shape, dtype), (inc, dy) in grids(torch).items():
        _, sparse = cuda_solver.inc_solve_sparse(inc, dy)

        def fn():
            return cuda_solver.inc_adjoint_ckpt(inc, sparse, dy)

        times, outs = {v: [] for v in VARIANTS}, {}
        for v in order:
            _build._lib = libs[v][0]
            times[v].append(k3_probe.event_ms(torch, fn))
            outs[v] = fn()
            torch.cuda.synchronize()
        _build._lib = libs["chosen"][0]
        same = all(torch.equal(outs["chosen"], o) for o in outs.values())
        ok &= same
        text = ", ".join(f"{v} {t[0]:.3f} / {t[1]:.3f} ms"
                         for v, t in times.items())
        best = {v: min(t) for v, t in times.items()}
        ratio = ", ".join(f"{v} {best[v] / best['chosen']:.3f}"
                          for v in VARIANTS if v != "chosen")
        print(f"[k8] K8 at the {shape} shape ({PAIRS} pairs, len {LENGTH}, "
              f"dyadic {dy}) {str(dtype)[6:]}: {text}; best over chosen's: "
              f"{ratio}; bit-equal {same} ({where})")
        del outs, sparse
        torch.cuda.empty_cache()
    print("[k8] ok" if ok else "[k8] FAILED: outputs differ")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
