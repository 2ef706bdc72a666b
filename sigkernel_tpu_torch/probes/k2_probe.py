"""K2, K2-stack and K2-sparse on the band-pipelined wavefront
(``csrc/band_sweep.cuh`` with ``IncSource``) against another checkout's,
measured on a CUDA card.

For the checkout holding this file and for the one under ``--parent DIR``
(unpacked with ``git archive``), each in a process of its own in the order
parent, this, this, parent, it builds the kernels library and times (CUDA
events, the mean of 5 launches after a warm-up), in both dtypes, on the RBF
kernel's increment grids of paths made as ``chip_smoke.py`` makes them:

- ``timed``: K2, K2-stack and K2-sparse (W 8) at 128 pairs of length 1024,
  dim 3, dyadic 1 (chip_smoke.py's timed shape);
- ``phase 12``: K2 and K2-sparse (W 8) at 128 pairs of length 1024, dim 5,
  dyadic 2 (R 4,092: phase 12's frame, where K2-sparse's launches are).

The outputs of every run must be equal bit for bit (compared by a hash of
their bytes). It then prints the registers and spills that ptxas reports
for the K2 family in both builds, and whether the SASS of any other kernel
in the library (``cuobjdump -sass``; K6, K7, K8, K5 among them) differs
from the parent's.

Then, in this process, what holds K2: the checkout's kernel (``chosen``,
``kIncAhead`` = 1) against libraries built from patched copies of
``csrc/``, at both shapes and dtypes:

- ``ahead0``: ``GridSource``'s pattern, each value loaded at the wrap
  before its use and scaled as it is loaded (the kernels instantiated on
  ``CkptSource``, a ``GridSource`` over the whole frame), ``ahead2``,
  ``ahead4``: queues of 2 and 4 base columns (all bit-equal to chosen);
- ``loads``: every grid load stays, the scheme goes (a cell adds its
  increment to its west value);
- ``no_loads``: the increment is a constant, no grid is read;

and K2-sparse at W = 2 against W = 8 on the chosen library. With
``--memcheck``, if ``compute-sanitizer`` is on the machine, it also runs
the three instances under its memcheck at a small odd shape (R 37, C 301,
W 8) and prints what it says.

Run from the repository root on a machine with a CUDA card::

    python3 sigkernel_tpu_torch/probes/k2_probe.py --parent DIR
        [--variants-only] [--memcheck]
"""
from __future__ import annotations

import argparse
import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]  # the checkout holding this file
sys.path.insert(0, str(Path(__file__).resolve().parent))
import k3_probe  # noqa: E402  (card, make_paths, event_ms, patched)
import k5_probe  # noqa: E402  (sass, entries)

DEVICE = "cuda"
LENGTH = 1024
# shape: (pairs, dim, dyadic, kernels timed)
SHAPES = {"timed": (128, 3, 1, ("K2", "K2-stack", "K2-sparse")),
          "phase 12": (128, 5, 2, ("K2", "K2-sparse"))}
WINDOW = 8  # K2-sparse's window (cuda_solver.CKPT_WINDOW's default)
_AHEAD = r"constexpr int kIncAhead = 1;"
VARIANTS = {
    "ahead0": [("inc_wavefront.cu", r"IncSource<T>", "CkptSource<T>", 2)],
    "ahead2": [("band_sweep.cuh", _AHEAD, "constexpr int kIncAhead = 2;", 1)],
    "ahead4": [("band_sweep.cuh", _AHEAD, "constexpr int kIncAhead = 4;", 1)],
    "loads": [("band_sweep.cuh",
               r"  return scheme\(nw, n, w, u, naive\);",
               "  return add(w, u);", 1)],
    "no_loads": [("band_sweep.cuh",
                  r"__ldg\(g \+ q \* step\) : T\(0\)",
                  "T(0.001) : T(0)", 1)],
}
# the variants that keep the kernel's arithmetic: their outputs must equal
# the chosen kernel's bit for bit
EXACT = ("ahead0", "ahead2", "ahead4")
K2_FAMILY = ("IncSource", "inc_wavefront")


def grids(torch):
    """``{(shape, dtype): (grid, dyadic, kernels)}`` at both shapes."""
    import sigkernel_tpu_torch as skt
    from sigkernel_tpu_torch.utils import double_difference

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    out = {}
    for shape, (P, D, dyadic, kernels) in SHAPES.items():
        X64, Y64 = (k3_probe.make_paths(torch, gen, P, LENGTH, D,
                                        torch.float64) for _ in range(2))
        for dtype in (torch.float32, torch.float64):
            out[(shape, dtype)] = (double_difference(
                skt.RBFKernel(1.0).batch_kernel(X64.to(dtype), Y64.to(dtype))
            ).contiguous(), dyadic, kernels)
        del X64, Y64
    return out


def calls(cuda_solver):
    """``{kernel: fn(grid, dyadic)}``: each instance's outputs, a tuple
    (K2-sparse's at :data:`WINDOW`)."""
    def sparse(g, d):
        cuda_solver.CKPT_WINDOW = WINDOW
        return cuda_solver.inc_solve_sparse(g, d)

    return {"K2": lambda g, d: (cuda_solver.inc_solve_final(g, d),),
            "K2-stack": cuda_solver.inc_solve_stack, "K2-sparse": sparse}


def digest(outs) -> str:
    """A hash of the bytes of the tensors ``outs``, a chunk at a time."""
    h = hashlib.sha256()
    for t in outs:
        flat = t.contiguous().flatten()
        for s in range(0, flat.numel(), 1 << 26):
            h.update(flat[s:s + (1 << 26)].cpu().numpy())
    return h.hexdigest()


def _timed(torch, fn):
    """``[ms, hash of the outputs' bytes]`` of ``fn``."""
    ms = k3_probe.event_ms(torch, fn)
    out = digest(fn())
    torch.cuda.empty_cache()
    return [ms, out]


def time_kernels(torch) -> dict:
    """``{"build_s", "lib", "log", "<kernel> <shape> <dtype>": [ms, output
    hash]}`` of the K2 family, with the checkout first on ``sys.path``."""
    from sigkernel_tpu_torch.ops import _build, cuda_solver

    _build.library()
    out = {"build_s": _build.build_seconds,
           "lib": str(_build.library_path()),
           "log": str(_build.library_path().parent / "nvcc.log")}
    fns = calls(cuda_solver)
    for (shape, dtype), (g, dyadic, kernels) in grids(torch).items():
        for k in kernels:
            out[f"{k} {shape} {str(dtype)[6:]}"] = _timed(
                torch, lambda: fns[k](g, dyadic))
    return out


def memcheck(torch) -> None:
    """The three instances under compute-sanitizer's memcheck at R 37, C
    301, W 8, if the tool is on the machine."""
    tool = shutil.which("compute-sanitizer") or next(
        (str(p) for p in (Path("/usr/local/cuda/bin/compute-sanitizer"),)
         if p.exists()), None)
    if tool is None:
        print("[k2] memcheck: compute-sanitizer is not on this machine")
        return
    code = ("import sys, torch; sys.path.insert(0, %r); "
            "from sigkernel_tpu_torch.ops import cuda_solver as c; "
            "g = torch.randn(3, 37, 301, dtype=torch.float64, "
            "device='cuda') * 0.01; c.CKPT_WINDOW = 8; "
            "[c.inc_solve_final(g.to(t)) for t in (torch.float32, "
            "torch.float64)]; [c.inc_solve_stack(g.to(t)) for t in "
            "(torch.float32, torch.float64)]; [c.inc_solve_sparse(g.to(t)) "
            "for t in (torch.float32, torch.float64)]; "
            "torch.cuda.synchronize(); print('memcheck run done')"
            % str(HERE))
    try:
        res = subprocess.run([tool, "--tool", "memcheck", sys.executable,
                              "-c", code], capture_output=True, text=True,
                             timeout=600)
        tail = (res.stdout + res.stderr).strip().splitlines()[-6:]
        print(f"[k2] memcheck: exit {res.returncode}")
        for line in tail:
            print(f"[k2] memcheck: {line}")
    except subprocess.TimeoutExpired:
        print("[k2] memcheck: did not finish within 600 s")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="a checkout to time K2 against")
    parser.add_argument("--variants-only", action="store_true",
                        help="time only the patched variants")
    parser.add_argument("--memcheck", action="store_true",
                        help="also run compute-sanitizer's memcheck")
    parser.add_argument("--time-kernels", metavar="ROOT",
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    sys.path.insert(0, args.time_kernels or str(HERE))
    import torch

    if not torch.cuda.is_available():
        print("k2_probe: no CUDA device", file=sys.stderr)
        return 1
    if args.time_kernels:
        print(json.dumps(time_kernels(torch)))
        return 0
    where = k3_probe.card()
    ok = True
    if not args.variants_only:
        if not args.parent:
            parser.error("--parent DIR is needed unless --variants-only")
        ok &= compare_parent(Path(args.parent).resolve(), where)
    ok &= variants(torch, where)
    if args.memcheck:
        memcheck(torch)
    print("[k2] ok" if ok else "[k2] FAILED: outputs differ")
    return 0 if ok else 1


def compare_parent(parent: Path, where: str) -> bool:
    """Parent, this, this, parent, a process each; True if every output is
    the same bit for bit."""
    runs = {"parent": [], "this": []}
    for who in ("parent", "this", "this", "parent"):
        root = str(parent if who == "parent" else HERE)
        res = subprocess.run([sys.executable, __file__, "--time-kernels",
                              root], capture_output=True, text=True,
                             check=True, cwd=root)
        runs[who].append(json.loads(res.stdout.strip().splitlines()[-1]))
    ok = True
    for who, (first, _) in runs.items():
        sec = first["build_s"]
        print(f"[k2] {who}: library built in "
              f"{f'{sec:.1f} s' if sec is not None else 'cached'}")
    for key in (k for k in runs["this"][0]
                if k not in ("build_s", "lib", "log")):
        a, b = ([r[key][0] for r in runs[w]] for w in ("parent", "this"))
        same = len({r[key][1] for w in runs.values() for r in w}) == 1
        ok &= same
        print(f"[k2] {key} (len {LENGTH}): parent {a[0]:.3f} / {a[1]:.3f} "
              f"ms, this {b[0]:.3f} / {b[1]:.3f} ms, best parent / best "
              f"this {min(a) / min(b):.3f}; bit-equal {same} ({where})")
    logs = {w: k5_probe.entries(Path(r[0]["log"])) for w, r in runs.items()}
    for who, found in logs.items():
        for name, (n, spill) in found.items():
            if any(k in name for k in K2_FAMILY):
                print(f"[k2] {who}: {name}: {n} registers, {spill}")
    code = {w: k5_probe.sass(Path(r[0]["lib"])) for w, r in runs.items()}
    others = [k for k in code["this"] if not any(f in k for f in K2_FAMILY)]
    differ = [k for k in others if code["parent"].get(k) != code["this"][k]]
    gone = [k for k in code["parent"] if k not in code["this"]]
    print(f"[k2] the other kernels' SASS (cuobjdump): {len(others)} "
          f"functions, {len(differ)} differ from the parent's; gone from "
          f"the library: {gone}")
    for k in differ:
        print(f"[k2]   {k}")
    return ok


def variants(torch, where) -> bool:
    """Time ``chosen`` against each of :data:`VARIANTS` (see above) in the
    order chosen, the variants, the variants reversed, chosen, and
    K2-sparse at W 2 against W 8; True if the chosen library's outputs stay
    the same through the runs and those of the :data:`EXACT` variants
    equal them."""
    from sigkernel_tpu_torch.ops import _build, cuda_solver

    src = _build._CSRC
    libs = {"chosen": _build.library()}
    try:
        for name, patches in VARIANTS.items():
            _build._CSRC = k3_probe.patched(_build, src, f"k2_{name}",
                                            patches)
            _build._lib, _build.build_seconds = None, None
            libs[name] = _build.library()
            print(f"[k2] {name}: library built in "
                  f"{_build.build_seconds:.1f} s")
            for kernel, (n, spill) in k5_probe.entries(
                    _build.library_path().parent / "nvcc.log").items():
                if "IncSource" in kernel and ", 0, 1, " in kernel:
                    print(f"[k2] {name}: {kernel}: {n} registers, {spill}")
    finally:
        _build._CSRC = src
        _build._lib = libs["chosen"]
    order = list(libs) + list(libs)[::-1]
    ok = True
    for (shape, dtype), (g, dyadic, _) in grids(torch).items():
        def fn():
            return cuda_solver.inc_solve_final(g, dyadic)

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
        print(f"[k2] K2 {shape} {str(dtype)[6:]}: {text}; best over "
              f"chosen's: {ratio}; {', '.join(EXACT)} bit-equal to chosen "
              f"{same} ({where})")
        sparse = {}
        for W in (WINDOW, 2, 2, WINDOW):
            cuda_solver.CKPT_WINDOW = W
            sparse.setdefault(W, []).append(k3_probe.event_ms(
                torch, lambda: cuda_solver.inc_solve_sparse(g, dyadic)))
            torch.cuda.empty_cache()
        cuda_solver.CKPT_WINDOW = WINDOW
        print(f"[k2] K2-sparse {shape} {str(dtype)[6:]}: W {WINDOW} "
              f"{sparse[WINDOW][0]:.3f} / {sparse[WINDOW][1]:.3f} ms, W 2 "
              f"{sparse[2][0]:.3f} / {sparse[2][1]:.3f} ms; best W 2 over "
              f"best W {WINDOW}: {min(sparse[2]) / min(sparse[WINDOW]):.3f} "
              f"({where})")
        del outs
    return ok


if __name__ == "__main__":
    sys.exit(main())
