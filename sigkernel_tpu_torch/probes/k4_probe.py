"""K4 (``csrc/rbf_dd_vjp.cu``, one tiled pass) against another checkout's
K4, and what holds it, measured on a CUDA card.

For the checkout holding this file and for the one under ``--parent DIR``
(unpacked with ``git archive``), each in a process of its own in the order
parent, this, this, parent, it builds the kernels library and times K4
through its wrapper ``incvjp.rbf_dd_vjp`` (CUDA events, the mean of 5 calls
after a warm-up; the wrapper's ``index_add_`` included, as
``chip_smoke.py`` times it) in both dtypes at two shapes, pairs of length
1024, dim 3, on a seeded normal ct ``(P, 1023, 1023)``:

- ``timed``: 128 pairs (``chip_smoke.py``'s timed shape, a lincomb chunk);
- ``tail``: 16 pairs (the main path's last chunk of 10,000 pairs).

Beside each time it gives K4's kernels' own device time a call
(``torch.profiler``, the kernels whose names hold ``rbf_dd_vjp``): the
rest is the wrapper's (its index check waits for the card, and the
``index_add_``). This checkout's two runs must be equal bit for bit (by a
hash of their bytes), and the parent's results within the gradient bars
of this one's (1e-10 / 1e-4 of max |ref|: the two sum in other orders).
It then prints the registers and spills that ptxas reports for K4's
kernels in both builds, and whether the SASS (``cuobjdump -sass``) of any
other kernel in the library differs from the parent's.

Then, in this process, what holds K4: the checkout's kernel (``chosen``)
against libraries built from patched copies of ``csrc/`` and against other
band heights, at both shapes and dtypes:

- ``no_exp``: the cell's ``exp`` gone (G = -D / sigma; the division
  stays);
- ``no_math``: no distance, division or exp (D = 0, G = 1): the ct loads,
  the west shuffles, dG, and every sum and reduction stay;
- ``loads``: as ``no_math``, and the products with the points and the
  row's reduce-scatter gone: what is left is reading ct, dG, the column and
  row sums of W alone;
- ``kc2``: 2 columns a lane instead of 4 (a row's loads, shuffles and
  reduce-scatter spread over half the cells);
- ``stages16``: the ct ring 16 rows ahead instead of 4;
- ``occ3``: at most 85 registers in float, so 3 blocks share an SM;
- ``band 32``, ``band 128``: ``incvjp.BAND_ROWS`` at 32 and 128 rows (64 is
  the kernel's), no rebuild.

``kc2`` and the bands sum in another order, so they are held to the
gradient bars; ``stages16`` and ``occ3`` keep the arithmetic and must
equal the chosen kernel bit for bit.

``--variants-only`` skips the comparison with the parent.

Run from the repository root on a machine with a CUDA card::

    python3 sigkernel_tpu_torch/probes/k4_probe.py --parent DIR
        [--variants-only]
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]  # the checkout holding this file
sys.path.insert(0, str(Path(__file__).resolve().parent))
import k3_probe  # noqa: E402  (card, make_paths, event_ms, patched)
import k5_probe  # noqa: E402  (sass, entries)

DEVICE = "cuda"
LENGTH, DIM = 1024, 3
SHAPES = {"timed": 128, "tail": 16}  # pairs
BARS = {"float64": 1e-10, "float32": 1e-4}
_CELL = "rbf_dd_vjp.cu"
_NO_MATH = [(_CELL, r"const T dist = sub\(add\(sx, sy\), mul\(T\(2\), dot\)\);",
             "const T dist = T(0);", 1),
            (_CELL, r"const T G = sk_exp\(-dist / sigma\);", "const T G = T(1);",
             1)]
VARIANTS = {
    "no_exp": [(_CELL, r"const T G = sk_exp\(-dist / sigma\);",
                "const T G = -dist / sigma;", 1)],
    "no_math": _NO_MATH,
    "loads": _NO_MATH + [
        (_CELL, r"vjp_scatter<kV, 16>\(v, lane\);", "", 1),
        (_CELL, r"cx\[k\]\[d\] = add\(cx\[k\]\[d\], mul\(e\.W, xm\[d\]\)\);",
         "", 1),
        (_CELL, r"v\[1 \+ d\] = add\(v\[1 \+ d\], mul\(e\.W, yv\[k\]\[d\]\)\);",
         "", 1)],
    "kc2": [(_CELL, r"return kD > 0 \? 4 : 1;", "return kD > 0 ? 2 : 1;", 1)],
    "stages16": [(_CELL, r"constexpr int kVjpStages = 4;",
                  "constexpr int kVjpStages = 16;", 1)],
    "occ3": [(_CELL, r"__launch_bounds__\(kVjpThreads, kD <= 4 \? 2 : 1\)",
              "__launch_bounds__(kVjpThreads, "
              "kD <= 4 ? (sizeof(T) == 4 ? 3 : 2) : 1)", 1)],
}
# the variants that keep the kernel's arithmetic: equal to the chosen bit
# for bit; the others that keep its function: within the gradient bars
EXACT = ("stages16", "occ3")
NEAR = ("kc2",)
BANDS = (32, 128)


def inputs(torch):
    """``{(shape, dtype): (X, Y, ii, ct)}``: seeded paths and a normal ct."""
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    out = {}
    for shape, P in SHAPES.items():
        X64, Y64 = (k3_probe.make_paths(torch, gen, P, LENGTH, DIM,
                                        torch.float64) for _ in range(2))
        ct64 = torch.randn(P, LENGTH - 1, LENGTH - 1, generator=gen,
                           device=DEVICE, dtype=torch.float64)
        ar = torch.arange(P, device=DEVICE)
        for dtype in (torch.float32, torch.float64):
            out[(shape, dtype)] = (X64.to(dtype), Y64.to(dtype), ar,
                                   ct64.to(dtype))
    return out


def _call(incvjp, X, Y, ii, ct):
    return incvjp.rbf_dd_vjp(X, Y, ii, ii, 1.0, ct)


def device_ms(torch, fn, reps=5):
    """K4's kernels' device time a call of ``fn``, by ``torch.profiler``."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if "rbf_dd_vjp" in e.key) / reps / 1e3


def _hash(out):
    h = hashlib.sha256()
    for t in out:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def time_kernels(torch, save: Path) -> dict:
    """``{"build_s", "lib", "log", "K4 <shape> <dtype>": [ms, output
    hash, device ms]}`` at both shapes, with the checkout first on
    ``sys.path``; the outputs go to ``save``."""
    from sigkernel_tpu_torch.ops import _build, incvjp

    _build.library()
    out = {"build_s": _build.build_seconds,
           "lib": str(_build.library_path()),
           "log": str(_build.library_path().parent / "nvcc.log")}
    results = {}
    for (shape, dtype), (X, Y, ii, ct) in inputs(torch).items():
        key = f"K4 {shape} {str(dtype)[6:]}"
        ms = k3_probe.event_ms(torch, lambda: _call(incvjp, X, Y, ii, ct))
        res = _call(incvjp, X, Y, ii, ct)
        out[key] = [ms, _hash(res),
                    device_ms(torch, lambda: _call(incvjp, X, Y, ii, ct))]
        results[key] = [t.cpu() for t in res]
    torch.save(results, save)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="a checkout to time K4 against")
    parser.add_argument("--variants-only", action="store_true",
                        help="time only the patched variants")
    parser.add_argument("--time-kernels", metavar="ROOT",
                        help=argparse.SUPPRESS)
    parser.add_argument("--save", help=argparse.SUPPRESS)
    args = parser.parse_args()
    sys.path.insert(0, args.time_kernels or str(HERE))
    import torch

    if not torch.cuda.is_available():
        print("k4_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.time_kernels:
        print(json.dumps(time_kernels(torch, Path(args.save))))
        return 0
    where = k3_probe.card()
    if args.variants_only:
        return 0 if variants(torch, where) else 1
    if not args.parent:
        parser.error("--parent DIR is needed unless --variants-only")
    parent = str(Path(args.parent).resolve())
    outdir = HERE / "build" / "k4_probe"
    outdir.mkdir(parents=True, exist_ok=True)
    runs = {"parent": [], "this": []}
    for n, who in enumerate(("parent", "this", "this", "parent")):
        root = parent if who == "parent" else str(HERE)
        save = outdir / f"{n}_{who}.pt"
        res = subprocess.run([sys.executable, __file__, "--time-kernels",
                              root, "--save", str(save)],
                             capture_output=True, text=True, check=True,
                             cwd=root)
        runs[who].append(json.loads(res.stdout.strip().splitlines()[-1]))
        runs[who][-1]["saved"] = str(save)
    ok = True
    for who, (first, _) in runs.items():
        sec = first["build_s"]
        print(f"[k4] {who}: library built in "
              f"{f'{sec:.1f} s' if sec is not None else 'cached'}")
    saved = {w: torch.load(r[0]["saved"]) for w, r in runs.items()}
    for key in (k for k in runs["this"][0] if k.startswith("K4 ")):
        a, b = ([r[key][0] for r in runs[w]] for w in ("parent", "this"))
        dev = {w: min(r[key][2] for r in runs[w]) for w in runs}
        same = len({r[key][1] for r in runs["this"]}) == 1
        err = max(float((g - w).abs().max() / w.abs().max())
                  for g, w in zip(saved["this"][key], saved["parent"][key]))
        bar = BARS[key.split()[-1]]
        ok &= same and err <= bar
        print(f"[k4] {key} (len {LENGTH}, dim {DIM}): parent {a[0]:.3f} / "
              f"{a[1]:.3f} ms, this {b[0]:.3f} / {b[1]:.3f} ms, best this / "
              f"best parent {min(b) / min(a):.3f}; the kernels alone "
              f"(device) parent {dev['parent']:.3f}, this {dev['this']:.3f} "
              f"ms; this run to run "
              f"bit-equal {same}; vs parent {err:.2e} of max |ref| (bar "
              f"{bar:.0e}) ({where})")
    logs = {w: k5_probe.entries(Path(r[0]["log"])) for w, r in runs.items()}
    for who, found in logs.items():
        for name, (n, spill) in found.items():
            if "rbf_dd_vjp" in name:
                print(f"[k4] {who}: {name}: {n} registers, {spill}")
    code = {w: k5_probe.sass(Path(r[0]["lib"])) for w, r in runs.items()}
    others = [k for k in code["this"] if "rbf_dd_vjp" not in k]
    differ = [k for k in others if code["parent"].get(k) != code["this"][k]]
    print(f"[k4] the other kernels' SASS (cuobjdump): {len(others)} "
          f"functions, {len(differ)} differ from the parent's")
    for k in differ:
        print(f"[k4]   {k}")
    ok &= variants(torch, where)
    print("[k4] ok" if ok else "[k4] FAILED")
    return 0 if ok else 1


def variants(torch, where) -> bool:
    """Time ``chosen`` against each of :data:`VARIANTS` and :data:`BANDS`
    (see above), in the order chosen, the variants, the variants reversed,
    chosen, then each one's device time; True if the chosen library's
    results stay the same through the runs, the :data:`EXACT` variants'
    equal them and the :data:`NEAR` and band variants' are within
    :data:`BARS` of them."""
    from sigkernel_tpu_torch.ops import _build, incvjp

    src, band = _build._CSRC, incvjp.BAND_ROWS
    libs = {"chosen": _build.library()}
    try:
        for name, patches in VARIANTS.items():
            _build._CSRC = k3_probe.patched(_build, src, f"k4_{name}",
                                            patches)
            _build._lib, _build.build_seconds = None, None
            libs[name] = _build.library()
            print(f"[k4] {name}: library built in "
                  f"{_build.build_seconds:.1f} s")
            for kernel, (n, spill) in k5_probe.entries(
                    _build.library_path().parent / "nvcc.log").items():
                if "rbf_dd_vjp_band" in kernel:
                    print(f"[k4] {name}: {kernel}: {n} registers, {spill}")
    finally:
        _build._CSRC = src
        _build._lib = libs["chosen"]
    setups = {v: (lib, band) for v, lib in libs.items()}
    setups.update({f"band {h}": (libs["chosen"], h) for h in BANDS})
    order = list(setups) + list(setups)[::-1]
    ok = True
    try:
        for (shape, dtype), (X, Y, ii, ct) in inputs(torch).items():
            times, outs = {v: [] for v in setups}, {v: [] for v in setups}
            for v in order:
                _build._lib, incvjp.BAND_ROWS = setups[v]
                times[v].append(k3_probe.event_ms(
                    torch, lambda: _call(incvjp, X, Y, ii, ct)))
                outs[v].append(_call(incvjp, X, Y, ii, ct))
            want = outs["chosen"][0]
            same = all(torch.equal(g, w) for v in ("chosen",) + EXACT
                       for o in outs[v] for g, w in zip(o, want))
            bar = BARS[str(dtype)[6:]]
            near = all(float((g - w).abs().max() / w.abs().max()) <= bar
                       for v in NEAR + tuple(f"band {h}" for h in BANDS)
                       for o in outs[v] for g, w in zip(o, want))
            ok &= same and near
            best = {v: min(t) for v, t in times.items()}
            text = ", ".join(f"{v} {t[0]:.3f} / {t[1]:.3f} ms"
                             for v, t in times.items())
            ratio = ", ".join(f"{v} {best[v] / best['chosen']:.3f}"
                              for v in setups if v != "chosen")
            device = {}
            for v in setups:
                _build._lib, incvjp.BAND_ROWS = setups[v]
                device[v] = device_ms(
                    torch, lambda: _call(incvjp, X, Y, ii, ct))
            dev = ", ".join(f"{v} {t:.3f}" for v, t in device.items())
            print(f"[k4] {shape} {str(dtype)[6:]}: {text}; best over "
                  f"chosen's: {ratio}; device ms: {dev}; chosen run to run "
                  f"and {', '.join(EXACT)} bit-equal {same}, "
                  f"{', '.join(NEAR)} and bands within the bar {near} "
                  f"({where})")
            del outs
    finally:
        _build._lib, incvjp.BAND_ROWS = libs["chosen"], band
    return ok


if __name__ == "__main__":
    sys.exit(main())
