"""How K3<gen>'s band kernel (``csrc/band_sweep.cuh``, kBandAdjoint with
``csrc/rbf_gen.cuh``'s RbfSource) gets its forward stack values, measured
on a CUDA card.

The adjoint mode multiplies each reverse cell by a forward stack entry. The
kernel stages those entries in shared memory ``Src::kStage`` steps ahead by
``cp.async``, two buffers a warp: at 32 steps that is 64 KiB a block in
double. The depth is the increment source's: 16 steps for RbfSource
(K3<gen>), 32 for GridSource (K3<inc, boundary>). This builds more kernels
libraries from patched copies of ``csrc/`` and times them against the
checkout's (``chosen``) on the same inputs:

- ``swapped``: RbfSource 32 steps, GridSource 16 (each kernel's other
  depth);
- ``rbf8``: RbfSource 8 steps;
- ``direct``: no stage, each lane loading its entry through ``__ldg`` on
  the step that uses it (the lanes of a step read neighbouring addresses);
- ``cap4``: the band kernels compiled for 4 resident blocks an SM
  (``__launch_bounds__(128, 4)``: at most 128 registers a thread).

The order is each variant once, then each again in reverse (CUDA events,
the mean of 5 launches after a warm-up each), and the outputs must be
equal bit for bit: K3<gen> at ``chip_smoke.py``'s timed shape (128 pairs
of length 1024, dim 3, dyadic 1) and K3<inc, boundary> at its timed shape
(16 pairs of length 5,001, dim 5, dyadic 2, one stripe of 2,048 rows). It
also prints each library's build time and the registers and spills that
ptxas reports for K3<gen>'s band instances at f = 2, D 3 and 5, and
K3<inc, boundary>'s at f = 4.

``--parent DIR`` (a checkout of another commit, unpacked with ``git
archive``) first builds that checkout's library and times K1, K1-stack,
K3<gen> and K4 at the timed shape in both dtypes for the two checkouts,
each in a process of its own, in the order parent, this, this, parent.
It also times the cotangent weighted per pair, as the generator's backward
asks for it (``rbf_gen_adjoint(..., g=w)`` where the wrapper takes ``g``,
else the cotangent times ``w``), splits that call's device time
(``torch.profiler``) into the band kernel's and the rest (PyTorch's fill,
division and weighting), and checks that its output is the same bit for
bit in every run (a hash of its bytes). Then it prints the registers and
spills that ptxas reports for K3<gen>'s band instances (``band_stripe``
in kBandAdjoint with an RBF source) in both builds, and whether the SASS
of any other kernel differs from the parent's (``k5_probe.sass``,
``cuobjdump -sass``). ``--kernels-only`` stops there.

Run from the repository root on a machine with a CUDA card::

    python3 sigkernel_tpu_torch/probes/k3_probe.py [--parent DIR]
        [--kernels-only]
"""
from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]  # the checkout holding this file
sys.path.insert(0, str(Path(__file__).resolve().parent))
DEVICE = "cuda"
PAIRS, LENGTH = 128, 1024
STRIPE = (16, 5001, 5, 2)  # pairs, length, dim, dyadic of K3<inc, boundary>


def _depth(fname, now, then):
    return (fname, rf"static constexpr int kStage = {now};",
            f"static constexpr int kStage = {then};", 1)


# variant -> [(file, pattern, replacement, count)] on a copy of csrc/
_TERM = (r"stage\[\(\(\(s - 1\) / kStage\) & 1\) \* kStage \* 32 \+ js \* 32 "
         r"\+\s+lane\]")
VARIANTS = {
    "chosen": [],
    "swapped": [_depth("rbf_gen.cuh", 16, 32),
                _depth("band_sweep.cuh", 32, 16)],
    "rbf8": [_depth("rbf_gen.cuh", 16, 8)],
    "direct": [
        ("band_sweep.cuh", r"return sizeof\(T\) \* kBandWarps \* 2 \* "
         r"Src::kStage \* 32;", "return 0;", 1),
        ("band_sweep.cuh", r"prefetch\([^;]*\);", ";", 2),
        ("band_sweep.cuh", r"wait_async<1>\(\);", ";", 1),
        ("band_sweep.cuh", _TERM,
         "__ldg(stk + (rows + C - i0 - s) * stride + (rows - i))", 1),
    ],
    "cap4": [("band_sweep.cuh", r"__launch_bounds__\(kBandRows\)",
              "__launch_bounds__(kBandRows, 4)", 1)],
}
# the instances whose registers are printed: (dtype, mode, f, source)
_SHOWN = [("d", 2, 2, "RbfFoldSourceIdLi3E"),
          ("d", 2, 2, "RbfFoldSourceIdLi5E"),
          ("f", 2, 2, "RbfFoldSourceIfLi3E"), ("d", 2, 4, "GridSourceIdE"),
          ("f", 2, 4, "GridSourceIfE")]


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]


def make_paths(torch, gen, batch, length, dim, dtype):
    """``cumsum(normal) / sqrt(length)``, as ``chip_smoke.py`` makes them."""
    z = torch.randn(batch, length, dim, generator=gen, device=DEVICE,
                    dtype=torch.float64)
    return (z.cumsum(dim=1) / math.sqrt(length)).to(dtype)


def event_ms(torch, fn, reps=5):
    fn()  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def patched(_build, src, name, patches):
    """A copy of the sources ``src`` with ``patches`` applied, each checked
    to match as often as it should."""
    copy = _build._BUILD_ROOT.parent / f"probe_{name}_csrc"
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(src, copy)
    for fname, pattern, repl, count in patches:
        path = copy / fname
        text, n = re.subn(pattern, repl, path.read_text())
        if n != count:
            raise RuntimeError(f"{name}: {pattern!r} matched {n} times in "
                               f"{fname}, not {count}")
        path.write_text(text)
    return copy


def libraries(_build):
    """``{variant: (library, build seconds, nvcc.log path)}``."""
    src, libs = _build._CSRC, {}
    try:
        for name, patches in VARIANTS.items():
            _build._CSRC = (patched(_build, src, name, patches) if patches
                            else src)
            _build._lib, _build.build_seconds = None, None
            lib = _build.library()
            libs[name] = (lib, _build.build_seconds,
                          _build.library_path().parent / "nvcc.log")
    finally:
        _build._CSRC = src
        _build._lib = libs["chosen"][0] if "chosen" in libs else None
    return libs


def registers(log: Path):
    """``[(dtype, f, source, registers, spills)]`` of the ``_SHOWN``
    instances of band_stripe in a ptxas report."""
    lines = log.read_text().splitlines() if log.exists() else []
    key, spills, out = None, "", []
    for line in lines:
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"band_stripeI([fd])Li(\d)ELi(\d+)ENS_\d+(\w+?E)",
                          m.group(1))
            key = k and (k.group(1), int(k.group(2)), int(k.group(3)),
                         k.group(4))
            key = key if key in _SHOWN else None
            spills = ""
        elif key is None:
            continue
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            out.append((key[0], key[2], key[3], regs, spills))
    return out


def device_split(torch, fn, reps=5) -> list:
    """``[band kernel ms, other ms]``: the device time a call of ``fn`` in
    the kernels named ``band_stripe`` and in all others, by
    ``torch.profiler``."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = [0.0, 0.0]
    for e in prof.key_averages():
        split["band_stripe" not in e.key] += e.device_time_total
    return [t / reps / 1e3 for t in split]


def time_kernels(torch) -> dict:
    """``{kernel dtype: ms}`` of K1, K1-stack, K3<gen> and K4 at the timed
    shape, and of K3<gen>'s cotangent weighted per pair, with the package
    on ``sys.path``; the library's build seconds (None if it was built
    already), its path and its ptxas report; ``split``: the weighted
    call's device time (:func:`device_split`); ``hash``: its output's."""
    from sigkernel_tpu_torch.ops import _build, cuda_gen, incvjp

    _build.library()
    out = {"build_s": _build.build_seconds,
           "lib": str(_build.library_path()),
           "log": str(_build.library_path().parent / "nvcc.log"),
           "split": {}, "hash": {}}
    folds = "g" in inspect.signature(cuda_gen.rbf_gen_adjoint).parameters
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    ar = torch.arange(PAIRS, device=DEVICE)
    X64 = make_paths(torch, gen, PAIRS, LENGTH, 3, torch.float64)
    Y64 = make_paths(torch, gen, PAIRS, LENGTH, 3, torch.float64)
    for dtype in (torch.float32, torch.float64):
        X, Y = X64.to(dtype), Y64.to(dtype)
        name = str(dtype)[6:]
        out[f"K1 {name}"] = event_ms(torch, lambda: cuda_gen.
                                     rbf_gen_solve_final(X, Y, ar, ar, 1.0, 1))
        out[f"K1-stack {name}"] = event_ms(torch, lambda: cuda_gen.
                                           rbf_gen_solve_stack(X, Y, ar, ar,
                                                               1.0, 1))
        _, stk = cuda_gen.rbf_gen_solve_stack(X, Y, ar, ar, 1.0, 1)
        out[f"K3<gen> {name}"] = event_ms(torch, lambda: cuda_gen.
                                          rbf_gen_adjoint(X, Y, ar, ar, 1.0,
                                                          stk, 1))
        w = torch.linspace(-1.0, 1.0, PAIRS, device=DEVICE, dtype=dtype)

        def weighted():
            if folds:
                return cuda_gen.rbf_gen_adjoint(X, Y, ar, ar, 1.0, stk, 1,
                                                g=w)
            return cuda_gen.rbf_gen_adjoint(X, Y, ar, ar, 1.0, stk,
                                            1) * w[:, None, None]

        key = f"K3<gen> weighted {name}"
        out[key] = event_ms(torch, weighted)
        out["split"][key] = device_split(torch, weighted)
        out["hash"][key] = hashlib.sha256(
            weighted().cpu().numpy().tobytes()).hexdigest()
        ct = cuda_gen.rbf_gen_adjoint(X, Y, ar, ar, 1.0, stk, 1)
        del stk
        out[f"K4 {name}"] = event_ms(torch, lambda: incvjp.rbf_dd_vjp(
            X, Y, ar, ar, 1.0, ct))
        del ct
        torch.cuda.empty_cache()
    return out


def compare(parent: str, where: str) -> bool:
    """:func:`time_kernels` of the checkout under ``parent`` and of this
    one, each in a process of its own, parent, this, this, parent; True if
    the weighted cotangent was the same in every run and no kernel but
    K3<gen>'s band instances changed its SASS."""
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
        print(f"[k3] {who}: library built in {built}")
    for key in runs["this"][0]:
        if key in ("build_s", "lib", "log", "split", "hash"):
            continue
        a, b = ([r[key] for r in runs[w]] for w in ("parent", "this"))
        print(f"[k3] {key} at {PAIRS} pairs, len {LENGTH}, dim 3, dyadic 1: "
              f"parent {a[0]:.3f} / {a[1]:.3f} ms, this {b[0]:.3f} / "
              f"{b[1]:.3f} ms, best this / best parent "
              f"{min(b) / min(a):.3f} ({where})")
    ok = True
    for key in runs["this"][0]["split"]:
        text = "; ".join(
            f"{w} " + ", ".join(f"{band:.3f} + {other:.3f}"
                                for band, other in (r["split"][key]
                                                    for r in runs[w]))
            for w in runs)
        same = len({r["hash"][key] for w in runs.values() for r in w}) == 1
        ok &= same
        print(f"[k3] {key}, device ms, band kernel + the rest: {text}; "
              f"bit-equal {same} ({where})")
    return ok and sass_unchanged(runs)


# K3<gen>'s band instances: band_stripe in kBandAdjoint (2) with an RBF
# source, demangled
_K3_GEN = re.compile(r"band_stripe<\w+, 2, \d+, sigkernel::Rbf\w*Source<")


def sass_unchanged(runs) -> bool:
    """Print the registers and spills of K3<gen>'s band instances in both
    builds (``runs``: :func:`compare`'s), and whether any other kernel's
    SASS differs from the parent's; True if none does."""
    import k5_probe

    logs = {w: k5_probe.entries(Path(r[0]["log"])) for w, r in runs.items()}
    for who, found in logs.items():
        for name, (n, spill) in found.items():
            if _K3_GEN.search(name):
                print(f"[k3] {who}: {name}: {n} registers, {spill}")
    code = {w: k5_probe.sass(Path(r[0]["lib"])) for w, r in runs.items()}
    mine = {w: {k for k in c if _K3_GEN.search(k)} for w, c in code.items()}
    others = [k for k in code["this"] if k not in mine["this"]]
    differ = [k for k in others if code["parent"].get(k) != code["this"][k]]
    gone = [k for k in code["parent"]
            if k not in code["this"] and k not in mine["parent"]]
    print(f"[k3] K3<gen>'s band instances: parent {len(mine['parent'])}, "
          f"this {len(mine['this'])}; the other kernels' SASS (cuobjdump): "
          f"{len(others)} functions, {len(differ)} differ from the parent's, "
          f"{len(gone)} of the parent's gone")
    for k in differ + gone:
        print(f"[k3]   {k}")
    return not (differ or gone)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="a checkout to time K1, K1-stack, "
                        "K3<gen> and K4 against first")
    parser.add_argument("--kernels-only", action="store_true",
                        help="stop after the comparison with --parent")
    parser.add_argument("--time-kernels", metavar="ROOT",
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    sys.path.insert(0, args.time_kernels or str(HERE))
    import torch

    if not torch.cuda.is_available():
        print("k3_probe: no CUDA device", file=sys.stderr)
        return 1
    if args.time_kernels:
        print(json.dumps(time_kernels(torch)))
        return 0
    if args.parent:
        same = compare(args.parent, card())
        print("[k3] parent comparison ok" if same else
              "[k3] FAILED: outputs or other kernels' SASS differ")
        if args.kernels_only:
            return 0 if same else 1
    from sigkernel_tpu_torch.ops import _build, cuda_blocked, cuda_gen
    from sigkernel_tpu_torch.utils import double_difference
    import sigkernel_tpu_torch as skt

    where = card()
    libs = libraries(_build)
    for name, (_, sec, log) in libs.items():
        built = f"{sec:.1f} s" if sec is not None else "cached"
        print(f"[k3] {name}: library built in {built}")
        for dt, f, src, n, spill in registers(log):
            print(f"[k3] {name}: band_stripe<{dt}, kBandAdjoint, {f}, "
                  f"{src}>: {n} registers, {spill}")
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    ar = torch.arange(PAIRS, device=DEVICE)
    X64 = make_paths(torch, gen, PAIRS, LENGTH, 3, torch.float64)
    Y64 = make_paths(torch, gen, PAIRS, LENGTH, 3, torch.float64)
    Ps, Ls, Ds, dys = STRIPE
    Z64 = make_paths(torch, gen, Ps + 1, Ls, Ds, torch.float64)
    order = list(VARIANTS) + list(VARIANTS)[::-1]
    ok = True
    for dtype in (torch.float32, torch.float64):
        X, Y = X64.to(dtype), Y64.to(dtype)
        _, stk = cuda_gen.rbf_gen_solve_stack(X, Y, ar, ar, 1.0, 1)
        Z = Z64.to(dtype)
        inc = double_difference(skt.RBFKernel(1.0).batch_kernel(
            Z[:Ps], Z[1:])).contiguous()
        del Z
        rows = cuda_blocked.adjoint_rows(dys, inc.element_size())
        C = inc.shape[-1] * 2 ** dys
        ones = inc.new_ones(Ps, C + 1)
        _, sstk = cuda_blocked.stripe_solve_stack(inc, ones, 0, rows, dys)
        kernels = {
            f"K3<gen> {PAIRS} pairs, len {LENGTH}, dim 3, dyadic 1":
                lambda: cuda_gen.rbf_gen_adjoint(X, Y, ar, ar, 1.0, stk, 1),
            f"K3<inc, boundary> {Ps} pairs, len {Ls}, dim {Ds}, dyadic {dys},"
            f" {rows} rows": lambda: cuda_blocked.stripe_adjoint(
                inc, sstk, ones, torch.zeros_like(inc), 0, rows, dys),
        }
        for label, fn in kernels.items():
            times, outs = {v: [] for v in VARIANTS}, {}
            for v in order:
                _build._lib = libs[v][0]
                times[v].append(event_ms(torch, fn))
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
            print(f"[k3] {label} {str(dtype)[6:]}: {text}; best over "
                  f"chosen's: {ratio}; bit-equal {same} ({where})")
            del outs
        del stk, sstk, inc, ones
        torch.cuda.empty_cache()
    print("[k3] ok" if ok else "[k3] FAILED: outputs differ")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
