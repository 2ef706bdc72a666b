"""K5 on the band-pipelined wavefront (``csrc/band_sweep.cuh`` with
``DerivSource``) against another checkout's K5, measured on a CUDA card.

For the checkout holding this file and for the one under ``--parent DIR``
(unpacked with ``git archive``), each in a process of its own in the order
parent, this, this, parent, it builds the kernels library and times K5
(CUDA events, the mean of 5 launches after a warm-up) at two shapes in both
dtypes, on the RBF kernel's derivative grids of ``chip_smoke.py``
(``deriv_grids``):

- ``timed``: 128 pairs of length 1024, dim 3, dyadic 1 (chip_smoke.py's
  timed shape);
- ``phase 7 tile``: 256 pairs (a 16 x 16 tile of the derivative Gram at
  ``max_batch=16``), length 1024, dim 3, dyadic 1;

and K1, K1-stack and K3<gen>, the same band kernel on another source, at
the timed shape. The outputs of every run must be equal bit for bit
(compared by a hash of their bytes). It then prints the registers and
spills that ptxas reports for K5's instances in both builds, whether any
other ``band_stripe`` instance's changed, and whether the SASS of any
other kernel in the library (``cuobjdump -sass``) differs from the
parent's.

Then, in this process, what holds K5 back: the checkout's kernel
(``chosen``) against libraries built from patched copies of ``csrc/``, at
both shapes and dtypes:

- ``k_only``: the cell computes K alone and passes K_diff and K_diffdiff
  on unchanged (the same state, shuffles and hand-offs; the recurrences
  gone, and with them the loads of the two derivative grids, which the
  compiler drops; its derivatives are not the kernel's);
- ``k_loads``: as ``k_only``, but K_diff and K_diffdiff add their
  increments, so every load stays and only the recurrences go;
- ``occ6``, ``occ4``: the same kernel launched with dynamic shared memory
  that no block uses, so that at most 6 blocks share an SM in float (its
  registers allow 9) or at most 4 in both dtypes: fewer resident blocks of
  later bands waiting on the bands above.

``--variants-only`` skips the comparison with the parent.

Run from the repository root on a machine with a CUDA card::

    python3 sigkernel_tpu_torch/probes/k5_probe.py --parent DIR
        [--variants-only]
"""
from __future__ import annotations

import argparse
import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]  # the checkout holding this file
sys.path.insert(0, str(Path(__file__).resolve().parent))
import k3_probe  # noqa: E402  (card, make_paths, event_ms)

DEVICE = "cuda"
LENGTH, DIM = 1024, 3
SHAPES = {"timed": (128, 1), "phase 7 tile": (256, 1)}  # (pairs, dyadic)
# patched copies of csrc/ (see above): the derivative recurrences cut from
# the cell; and dynamic shared memory that leaves room for at most 6 blocks
# an SM in float (9 by its registers; double's 6 unchanged) or 4 in both,
# each block's static and dynamic shared memory within the 48 KB that
# needs no opt-in
_LAUNCH = r"kBandRows, 0,"
VARIANTS = {
    "k_only": [("band_sweep.cuh", r"  return \{k, d, s\};",
                "  return {k, nw.d, nw.s};", 1)],
    "k_loads": [("band_sweep.cuh", r"  return \{k, d, s\};",
                 "  return {k, add(nw.d, inc.d), add(nw.s, inc.s)};", 1)],
    "occ6": [("deriv_wavefront.cu", _LAUNCH,
              "kBandRows, sizeof(T) == 4 ? 27 * 1024 : 0,", 1)],
    "occ4": [("deriv_wavefront.cu", _LAUNCH,
              "kBandRows, sizeof(T) == 4 ? 36 * 1024 : 27 * 1024,", 1)],
}
# the variants that keep the kernel's arithmetic: their corners must equal
# the chosen kernel's bit for bit
EXACT = ("occ6", "occ4")


def grids(torch):
    """``{(shape, dtype): (three grids, dyadic)}`` at both shapes."""
    import sigkernel_tpu_torch as skt
    from chip_smoke import deriv_grids

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    out = {}
    for shape, (P, dyadic) in SHAPES.items():
        X64, Y64, G64 = (k3_probe.make_paths(torch, gen, P, LENGTH, DIM,
                                             torch.float64) for _ in range(3))
        ar = torch.arange(P, device=DEVICE)
        for dtype in (torch.float32, torch.float64):
            out[(shape, dtype)] = (deriv_grids(
                skt.RBFKernel(1.0), X64.to(dtype), Y64.to(dtype),
                G64.to(dtype), ar, ar), dyadic)
    return out


def _timed(torch, fn):
    """``[ms, hash of the output's bytes]`` of ``fn``."""
    ms = k3_probe.event_ms(torch, fn)
    return [ms, hashlib.sha256(fn().cpu().numpy().tobytes()).hexdigest()]


def time_kernels(torch) -> dict:
    """``{"build_s", "lib", "log", "<kernel> <shape> <dtype>": [ms, output
    hash]}`` of K5 at both shapes, and of K1, K1-stack and K3<gen> (other
    instances of the band kernel) at the timed shape, with the checkout
    first on ``sys.path``."""
    from sigkernel_tpu_torch.ops import _build, cuda_deriv, cuda_gen

    _build.library()
    out = {"build_s": _build.build_seconds,
           "lib": str(_build.library_path()),
           "log": str(_build.library_path().parent / "nvcc.log")}
    for (shape, dtype), (g, dyadic) in grids(torch).items():
        out[f"K5 {shape} {str(dtype)[6:]}"] = _timed(
            torch, lambda: torch.stack(
                cuda_deriv.deriv_solve_final(*g, dyadic)))
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    P, dyadic = SHAPES["timed"]
    X64, Y64 = (k3_probe.make_paths(torch, gen, P, LENGTH, DIM,
                                    torch.float64) for _ in range(2))
    ar = torch.arange(P, device=DEVICE)
    for dtype in (torch.float32, torch.float64):
        X, Y, dt = X64.to(dtype), Y64.to(dtype), str(dtype)[6:]
        out[f"K1 timed {dt}"] = _timed(torch, lambda: cuda_gen.
                                       rbf_gen_solve_final(X, Y, ar, ar, 1.0,
                                                           dyadic))
        out[f"K1-stack timed {dt}"] = _timed(
            torch, lambda: cuda_gen.rbf_gen_solve_stack(
                X, Y, ar, ar, 1.0, dyadic)[1])
        stack = cuda_gen.rbf_gen_solve_stack(X, Y, ar, ar, 1.0, dyadic)[1]
        out[f"K3<gen> timed {dt}"] = _timed(
            torch, lambda: cuda_gen.rbf_gen_adjoint(X, Y, ar, ar, 1.0, stack,
                                                    dyadic))
        del stack
        torch.cuda.empty_cache()
    return out


def sass(lib: Path) -> dict:
    """``{demangled kernel (no parameters): its SASS, addresses and
    encodings dropped}`` of a library, by ``cuobjdump -sass``."""
    from sigkernel_tpu_torch.ops import _build

    dump = Path(_build.find_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(dump), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    names, bodies = [], []
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\w+)", line)
        if m:
            names.append(m.group(1))
            bodies.append([])
        elif bodies:
            code = re.sub(r"/\*.*?\*/", "", line).strip()
            if code:
                bodies[-1].append(code)
    return dict(zip(demangled(names), ("\n".join(b) for b in bodies)))


def demangled(names):
    """The kernels' names without their parameter lists (``c++filt``)."""
    filt = shutil.which("c++filt")
    plain = (subprocess.run([filt], input="\n".join(names), text=True,
                            capture_output=True).stdout.splitlines()
             if filt else names)
    return [p.split("(")[0] for p in plain]


def entries(log: Path) -> dict:
    """``{demangled kernel (no parameters): (registers, spill line)}`` of a
    ptxas report."""
    lines = log.read_text().splitlines() if log.exists() else []
    names, regs, key, spills = [], {}, None, ""
    for line in lines:
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            key, spills = m.group(1), ""
            names.append(key)
        elif key and "spill" in line:
            spills = line.strip()
        elif key and "Used" in line and "registers" in line:
            regs[key] = (int(re.search(r"Used (\d+) registers",
                                       line).group(1)), spills)
    return {p: regs[n] for n, p in zip(names, demangled(names)) if n in regs}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="a checkout to time K5 against")
    parser.add_argument("--variants-only", action="store_true",
                        help="time only the patched variants")
    parser.add_argument("--time-kernels", metavar="ROOT",
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    sys.path.insert(0, args.time_kernels or str(HERE))
    import torch

    if not torch.cuda.is_available():
        print("k5_probe: no CUDA device", file=sys.stderr)
        return 1
    if args.time_kernels:
        print(json.dumps(time_kernels(torch)))
        return 0
    where = k3_probe.card()
    if args.variants_only:
        return 0 if variants(torch, where) else 1
    if not args.parent:
        parser.error("--parent DIR is needed unless --variants-only")
    parent = str(Path(args.parent).resolve())
    runs = {"parent": [], "this": []}
    for who in ("parent", "this", "this", "parent"):
        root = parent if who == "parent" else str(HERE)
        res = subprocess.run([sys.executable, __file__, "--parent",
                              parent, "--time-kernels", root],
                             capture_output=True, text=True, check=True,
                             cwd=root)
        runs[who].append(json.loads(res.stdout.strip().splitlines()[-1]))
    ok = True
    for who, (first, _) in runs.items():
        sec = first["build_s"]
        print(f"[k5] {who}: library built in "
              f"{f'{sec:.1f} s' if sec is not None else 'cached'}")
    for key in (k for k in runs["this"][0]
                if k not in ("build_s", "lib", "log")):
        a, b = ([r[key][0] for r in runs[w]] for w in ("parent", "this"))
        same = len({r[key][1] for w in runs.values() for r in w}) == 1
        ok &= same
        print(f"[k5] {key} (len {LENGTH}, dim {DIM}): parent {a[0]:.3f} / "
              f"{a[1]:.3f} ms, this {b[0]:.3f} / {b[1]:.3f} ms, best this / "
              f"best parent {min(b) / min(a):.3f}; bit-equal {same} ({where})")
    logs = {w: entries(Path(r[0]["log"])) for w, r in runs.items()}
    for who, found in logs.items():
        for name, (n, spill) in found.items():
            if "deriv" in name.lower():
                print(f"[k5] {who}: {name}: {n} registers, {spill}")
    band = [k for k in logs["this"] if "band_stripe" in k
            and "DerivSource" not in k]
    changed = [k for k in band if logs["parent"].get(k) != logs["this"][k]]
    print(f"[k5] other band_stripe instances: {len(band)}, of which "
          f"{len(changed)} differ from the parent's registers or spills")
    for k in changed:
        print(f"[k5]   {k}: parent {logs['parent'].get(k)}, this "
              f"{logs['this'][k]}")
    code = {w: sass(Path(r[0]["lib"])) for w, r in runs.items()}
    others = [k for k in code["this"] if "DerivSource" not in k]
    differ = [k for k in others if code["parent"].get(k) != code["this"][k]]
    print(f"[k5] the other kernels' SASS (cuobjdump): {len(others)} "
          f"functions, {len(differ)} differ from the parent's")
    for k in differ:
        print(f"[k5]   {k}")
    ok &= variants(torch, where)
    print("[k5] ok" if ok else "[k5] FAILED: corners differ")
    return 0 if ok else 1


def variants(torch, where) -> bool:
    """Time ``chosen`` against each of :data:`VARIANTS` (see above), in the
    order chosen, the variants, the variants reversed, chosen; True if the
    chosen library's corners stay the same through the runs and those of
    the :data:`EXACT` variants equal them."""
    from sigkernel_tpu_torch.ops import _build, cuda_deriv

    src = _build._CSRC
    libs = {"chosen": _build.library()}
    try:
        for name, patches in VARIANTS.items():
            _build._CSRC = k3_probe.patched(_build, src, f"k5_{name}",
                                            patches)
            _build._lib, _build.build_seconds = None, None
            libs[name] = _build.library()
            print(f"[k5] {name}: library built in "
                  f"{_build.build_seconds:.1f} s")
            for kernel, (n, spill) in entries(
                    _build.library_path().parent / "nvcc.log").items():
                if "DerivSource" in kernel:
                    print(f"[k5] {name}: {kernel}: {n} registers, {spill}")
    finally:
        _build._CSRC = src
        _build._lib = libs["chosen"]
    order = list(libs) + list(libs)[::-1]
    ok = True
    for (shape, dtype), (g, dyadic) in grids(torch).items():
        def fn():
            return torch.stack(cuda_deriv.deriv_solve_final(*g, dyadic))

        times, outs = {v: [] for v in libs}, {v: [] for v in libs}
        for v in order:
            _build._lib = libs[v]
            times[v].append(k3_probe.event_ms(torch, fn))
            outs[v].append(fn())
        _build._lib = libs["chosen"]
        want = outs["chosen"][0]
        same = all(torch.equal(want, o) for v in ("chosen",) + EXACT
                   for o in outs[v])
        ok &= same
        text = ", ".join(f"{v} {t[0]:.3f} / {t[1]:.3f} ms"
                         for v, t in times.items())
        best = {v: min(t) for v, t in times.items()}
        ratio = ", ".join(f"{v} {best[v] / best['chosen']:.3f}"
                          for v in VARIANTS)
        print(f"[k5] {shape} {str(dtype)[6:]}: {text}; best over chosen's: "
              f"{ratio}; {', '.join(EXACT)} bit-equal to chosen {same} "
              f"({where})")
        del outs
    return ok


if __name__ == "__main__":
    sys.exit(main())
