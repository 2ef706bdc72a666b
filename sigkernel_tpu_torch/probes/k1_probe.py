"""Two measurements of K1 (``csrc/rbf_gen_wavefront.cu``) on a CUDA card.

``source``: K1's RBF increment source keeps a lane's two base points in
registers for D = 1 .. 5 (``RbfSource<T, kD>``, kD = D) and reads them
through ``__ldg`` for any other D (kD = 0). This builds a second kernels
library from a copy of ``csrc/`` whose dispatch sends every D to the kD = 0
instance, and times the two libraries' K1 and K1-stack on the same inputs,
in the order register, generic, generic, register (CUDA events, the mean of
5 launches after a warm-up each), checking that their outputs are equal bit
for bit. Shapes: 128 pairs of length 1024 at dim 3, dyadic 1 (the timed
shape of ``chip_smoke.py``) and dyadic 0 (a base column used for one step),
and at dim 5, dyadic 2 (the frame of ``chip_smoke.py``'s phase 8, K1 only).

``peaks [--root DIR]``: the forward calls of ``chip_smoke.py``'s phases 2
(the 100 x 100 north-star Gram, float64 and float32) and 8 (CHSIC, m 50,
length 1024, dim 5, dyadic 2) with the package imported from ``DIR``
(default: this checkout), printing each phase's rate and peak allocated
memory. Run it on two checkouts in one call to compare their peaks.

Run from the repository root on a machine with a CUDA card::

    python3 sigkernel_tpu_torch/probes/k1_probe.py source
    python3 sigkernel_tpu_torch/probes/k1_probe.py peaks --root DIR
"""
from __future__ import annotations

import argparse
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]  # the checkout holding this file
DEVICE = "cuda"
PAIRS, LENGTH = 128, 1024
# (dim, dyadic order, with K1-stack)
SOURCE_SHAPES = [(3, 1, True), (3, 0, True), (5, 2, False)]
NORTH_STAR = 100            # chip_smoke.py phase 2: batch (length 1024, dim 3)
CHSIC = (50, 1024, 5, 2)    # chip_smoke.py phase 8: m, length, dim, dyadic


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


def generic_library(_build):
    """The kernels library built from a copy of ``csrc/`` in which K1's
    dispatch takes the kD = 0 instance for every D."""
    src = _build._CSRC
    copy = _build._BUILD_ROOT.parent / "probe_generic_csrc"
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(src, copy)
    cu = copy / "rbf_gen_wavefront.cu"
    text, n = re.subn(r"launch =\n.*?;",
                      "launch = &launch_gen_band<T, kStack, 0>;",
                      cu.read_text(), count=1, flags=re.DOTALL)
    if n != 1:
        raise RuntimeError("K1's dispatch was not found in "
                           "rbf_gen_wavefront.cu")
    cu.write_text(text)
    regular = _build.library()
    _build._CSRC, _build._lib = copy, None
    try:
        generic = _build.library()
    finally:
        _build._CSRC, _build._lib = src, regular
    return regular, generic


def source(torch) -> int:
    from sigkernel_tpu_torch.ops import _build, cuda_gen

    regular, generic = generic_library(_build)
    where = card()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    ar = torch.arange(PAIRS, device=DEVICE)
    ok = True
    for D, dy, with_stack in SOURCE_SHAPES:
        X64 = make_paths(torch, gen, PAIRS, LENGTH, D, torch.float64)
        Y64 = make_paths(torch, gen, PAIRS, LENGTH, D, torch.float64)
        for dtype in (torch.float32, torch.float64):
            X, Y = X64.to(dtype), Y64.to(dtype)
            kernels = [("K1", lambda: cuda_gen.rbf_gen_solve_final(
                X, Y, ar, ar, 1.0, dy))]
            if with_stack:
                kernels.append(("K1-stack", lambda: cuda_gen.
                                rbf_gen_solve_stack(X, Y, ar, ar, 1.0, dy)))
            for label, fn in kernels:
                times, outs = {"register": [], "generic": []}, {}
                for which in ("register", "generic", "generic", "register"):
                    _build._lib = regular if which == "register" else generic
                    times[which].append(event_ms(torch, fn))
                    outs[which] = fn()
                    torch.cuda.synchronize()
                _build._lib = regular
                a, b = outs["register"], outs["generic"]
                if isinstance(a, tuple):
                    same = all(torch.equal(u, v) for u, v in zip(a, b))
                else:
                    same = torch.equal(a, b)
                ok &= same
                reg, gen_ = min(times["register"]), min(times["generic"])
                print(f"[source] {label} {str(dtype)[6:]} {PAIRS} pairs, len "
                      f"{LENGTH}, dim {D}, dyadic {dy}: register (kD = {D}) "
                      f"{times['register'][0]:.3f} / "
                      f"{times['register'][1]:.3f} ms, generic (kD = 0) "
                      f"{times['generic'][0]:.3f} / "
                      f"{times['generic'][1]:.3f} ms, best generic / best "
                      f"register {gen_ / reg:.3f}, bit-equal {same} "
                      f"({where})")
                del outs, a, b
                torch.cuda.empty_cache()
    print("[source] ok" if ok else "[source] FAILED: outputs differ")
    return 0 if ok else 1


def peaks(torch) -> int:
    import sigkernel_tpu_torch as skt

    where = card()
    print(f"[peaks] package {Path(skt.__file__).parent} ({where})")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    A = NORTH_STAR
    X64 = make_paths(torch, gen, A, LENGTH, 3, torch.float64)
    Y64 = make_paths(torch, gen, A, LENGTH, 3, torch.float64)
    rbf = skt.RBFKernel(1.0)
    sig = skt.SigKernel(rbf, dyadic_order=1)
    for dtype in (torch.float64, torch.float32):
        X, Y = X64.to(dtype), Y64.to(dtype)
        W = torch.full((A, A), 1.0 / (A * A), dtype=dtype, device=DEVICE)
        calls = [
            ("compute_Gram(X, X, sym=True)", A * (A + 1) // 2,
             lambda: sig.compute_Gram(X, X, sym=True)),
            ("compute_Gram(X, Y)", A * A, lambda: sig.compute_Gram(X, Y)),
            ("sig_gram_lincomb(X, Y, W, pair_chunk=128)", A * A,
             lambda: skt.sig_gram_lincomb(rbf, X, Y, W, dyadic_order=1,
                                          pair_chunk=128)),
        ]
        for _, _, fn in calls:  # builds the library, warms the card
            fn()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for label, pairs, fn in calls:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            print(f"[peaks] phase 2 {str(dtype)[6:]} {label}: {sec:.3f} s, "
                  f"{pairs / sec:.1f} path-pairs/s")
        peak = torch.cuda.max_memory_allocated()
        print(f"[peaks] phase 2 {str(dtype)[6:]} peak {peak} bytes, "
              f"{peak - base} above the {base} allocated before the calls")
    m, L, D, dy = CHSIC
    XYZ = [make_paths(torch, gen, m, L, D, torch.float64) for _ in range(3)]
    fn = lambda: skt.sig_chsic(*XYZ, skt.RBFKernel(1.0), dyadic_order=dy)
    fn()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    value = fn()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    pairs = 3 * m * (m + 1) // 2
    print(f"[peaks] phase 8 float64 sig_chsic: {float(value)}, {sec:.3f} s, "
          f"{pairs / sec:.1f} path-pairs/s, peak {peak} bytes, "
          f"{peak - base} above the {base} allocated before the call")
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("what", choices=("source", "peaks"))
    parser.add_argument("--root", default=str(HERE),
                        help="checkout whose sigkernel_tpu_torch is "
                             "imported (default: this one)")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("k1_probe: no CUDA device", file=sys.stderr)
        return 1
    return source(torch) if args.what == "source" else peaks(torch)


if __name__ == "__main__":
    sys.exit(main())
