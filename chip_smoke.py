#!/usr/bin/env python3
"""Drive the PyTorch port's forward path on one NVIDIA GPU through its CUDA
kernels, and check it.

Run from the repository root, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

0. Device: the card's name and power limit, torch/CUDA versions, and the
   build of the kernels from ``sigkernel_tpu_torch/csrc`` (nvcc at first use).
1. Each kernel against its plain PyTorch version on the card: K1
   (``rbf_gen_wavefront``) and K2 (``inc_wavefront``) x {float32, float64} x
   {order-2, naive} x dyadic {0, 1, 2}, over the README quick-start shape
   (both orientations), 8 pairs at length 1024, one pair at length 2048
   (dyadic 1) and a length-1 path.
2. The main path at the north-star size: ``SigKernel(RBFKernel(1.0),
   dyadic_order=1)`` on X, Y of shape (100, 1024, 3), float64 and float32:
   ``compute_Gram(X, X, sym=True)``, ``compute_Gram(X, Y)``,
   ``compute_mmd(X, Y)`` and ``sig_gram_lincomb`` with ``pair_chunk=128``.
3. A ``LinearKernel`` ``sym=True`` Gram at batch 50, length 100 (through K2).
4. ``hypothesis_test`` at batch 32, length 200, dyadic 1.

The launch counters are zeroed before phases 2-4 and read after them: every
kernel must have launched and no plain version may have run. The checks of
those phases against plain versions come after the counters are read, then
each kernel is timed beside its plain version at 128 pairs, length 1024,
dyadic 1, dim 3. The last three lines of the output are the card's
``nvidia-smi`` line, one JSON object describing the kernels, and the result
line ``{"ok": true, "device": {...}}``.
"""
import json
import math
import subprocess
import sys
import time

# Kernel against plain version, max relative error. float64: the port's
# parity bar. float32: the kernels round in the plain versions' op order,
# but exp may round differently, and the double-difference cancellation
# amplifies that more on longer paths.
F64_RTOL = 1e-10
F32_RTOL_SMALL = 1e-4
F32_RTOL_LONG = 1e-3  # paths of length >= 1024
# float32 against float64 at the north star, max abs error over max |K|:
# the f32 sweep's own drift (it adds millions of rounding errors of one
# sign; not a kernel property)
F32_VS_F64 = 1e-1


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def rel_err(got, want):
    return float(((got - want).abs() / want.abs()).max())


def make_paths(gen, batch, length, dim, dtype):
    """``cumsum(normal) / sqrt(length)``, as the JAX benchmark makes them."""
    import torch

    z = torch.randn(batch, length, dim, generator=gen, device="cuda",
                    dtype=torch.float64)
    return (z.cumsum(dim=1) / math.sqrt(length)).to(dtype)


def synced(fn):
    """``(result, seconds)`` on the host clock, synchronised."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn, reps):
    """Mean milliseconds per call over ``reps`` calls, by CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    import sigkernel_tpu_torch as skt
    from sigkernel_tpu_torch.ops import _build, cuda_gen, cuda_solver
    from sigkernel_tpu_torch.utils import double_difference

    # full-precision float32 matmuls (the plain versions' Grams)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    F32, F64 = torch.float32, torch.float64
    dev = torch.device("cuda")

    # ---- phase 0: device and build --------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[0] card: {card}")
    print(f"[0] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, "
          f"devices {torch.cuda.device_count()}")
    _, t_lib = synced(_build.library)
    built = _build.build_seconds
    print(f"[0] kernels library {_build.library_path()} ready in "
          f"{t_lib:.1f} s ({'built' if built is not None else 'cached'})")
    log = _build.library_path().parent / "nvcc.log"
    for line in log.read_text().splitlines() if log.exists() else []:
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[0] ptxas: {line.strip()}")

    instances = {
        ("gen", F32): "rbf_gen_wavefront<float>",
        ("gen", F64): "rbf_gen_wavefront<double>",
        ("inc", F32): "inc_wavefront<float>",
        ("inc", F64): "inc_wavefront<double>",
    }
    max_abs = {k: 0.0 for k in instances}

    def compare(kind, dtype, got, want, limit, label):
        check(bool(torch.isfinite(got).all()), f"{label}: non-finite")
        check(got.shape == want.shape, f"{label}: shape {tuple(got.shape)}")
        r = rel_err(got, want) if got.numel() else 0.0
        a = float((got - want).abs().max()) if got.numel() else 0.0
        max_abs[(kind, dtype)] = max(max_abs[(kind, dtype)], a)
        check(r <= limit, f"{label}: rel err {r:.3e} > {limit:.0e}")
        return r

    # ---- phase 1: kernels against their plain versions ------------------
    gen = torch.Generator(device="cuda").manual_seed(1)
    problems = [
        # name, pairs, M, N, D, sigma, dyadic orders
        ("quick-start 5 pairs 10x20 d2", 5, 10, 20, 2, 0.5, (0, 1, 2)),
        ("quick-start 5 pairs 20x10 d2", 5, 20, 10, 2, 0.5, (0, 1, 2)),
        ("8 pairs 1024x1024 d3", 8, 1024, 1024, 3, 1.0, (0, 1, 2)),
        ("1 pair 2048x2048 d3", 1, 2048, 2048, 3, 1.0, (1,)),
        ("length-1 path 3 pairs 1x5 d2", 3, 1, 5, 2, 0.5, (0, 1, 2)),
    ]
    t_phase = time.perf_counter()
    for name, P, M, N, D, sigma, orders in problems:
        X64 = make_paths(gen, P, M, D, F64)
        Y64 = make_paths(gen, P, N, D, F64)
        ii = torch.arange(P, device=dev)
        jj = ii.flip(0)  # a non-identity pairing exercises the index arrays
        long = max(M, N) >= 1024
        rbf = skt.RBFKernel(sigma)
        for dtype in (F64, F32):
            X, Y = X64.to(dtype), Y64.to(dtype)
            inc = double_difference(
                rbf.batch_kernel(X[ii], Y[jj])).contiguous()
            limit = (F64_RTOL if dtype == F64 else
                     F32_RTOL_LONG if long else F32_RTOL_SMALL)
            for dy in orders:
                for naive in (False, True):
                    label = (f"{name} {str(dtype)[6:]} dyadic {dy} "
                             f"{'naive' if naive else 'order-2'}")
                    k1, t1 = synced(lambda: cuda_gen.rbf_gen_solve_final(
                        X, Y, ii, jj, sigma, dy, naive))
                    p1 = cuda_gen.rbf_gen_solve_final_plain(
                        X, Y, ii, jj, sigma, dy, naive)
                    r1 = compare("gen", dtype, k1, p1, limit, "K1 " + label)
                    k2, t2 = synced(lambda: cuda_solver.inc_solve_final(
                        inc, dy, naive))
                    p2 = cuda_solver.inc_solve_final_plain(inc, dy, naive)
                    r2 = compare("inc", dtype, k2, p2, limit, "K2 " + label)
                    torch.cuda.synchronize()
                    print(f"[1] {label}: K1 rel {r1:.2e} ({t1 * 1e3:.1f} ms),"
                          f" K2 rel {r2:.2e} ({t2 * 1e3:.1f} ms), "
                          f"limit {limit:.0e}")
    print(f"[1] all kernel-vs-plain cases passed in "
          f"{time.perf_counter() - t_phase:.1f} s")

    # ---- phases 2-4: the main path, counted -----------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    A, L = 100, 1024
    X64 = make_paths(gen, A, L, 3, F64)
    Y64 = make_paths(gen, A, L, 3, F64)
    XL64 = make_paths(gen, 50, 100, 3, F64)
    H64 = make_paths(gen, 32, 200, 3, F64)
    T64 = 1.5 * make_paths(gen, 32, 200, 3, F64)
    rbf = skt.RBFKernel(1.0)
    sig = skt.SigKernel(rbf, dyadic_order=1)

    for m in (cuda_gen, cuda_solver):
        for k in m.COUNTS:
            m.COUNTS[k] = 0
    main = {}
    for dtype in (F64, F32):
        X, Y = X64.to(dtype), Y64.to(dtype)
        W = torch.full((A, A), 1.0 / (A * A), dtype=dtype, device=dev)
        torch.cuda.reset_peak_memory_stats()
        calls = [
            ("compute_Gram(X, X, sym=True)", A * (A + 1) // 2,
             lambda: sig.compute_Gram(X, X, sym=True)),
            ("compute_Gram(X, Y)", A * A, lambda: sig.compute_Gram(X, Y)),
            ("compute_mmd(X, Y)", A * (A + 1) + A * A,
             lambda: sig.compute_mmd(X, Y)),
            ("sig_gram_lincomb(X, Y, W, pair_chunk=128)", A * A,
             lambda: skt.sig_gram_lincomb(rbf, X, Y, W, dyadic_order=1,
                                          pair_chunk=128)),
        ]
        for label, pairs, fn in calls:
            out, sec = synced(fn)
            main[(dtype, label)] = out
            print(f"[2] {str(dtype)[6:]} {label}: {sec:.3f} s, "
                  f"{pairs / sec:.1f} path-pairs/s ({pairs} pairs)")
        print(f"[2] {str(dtype)[6:]} peak memory allocated "
              f"{torch.cuda.max_memory_allocated()} bytes")

    lin = skt.SigKernel(skt.LinearKernel(1.0), dyadic_order=0)
    for dtype in (F64, F32):
        XL = XL64.to(dtype)
        out, sec = synced(lambda: lin.compute_Gram(XL, XL, sym=True))
        main[(dtype, "linear")] = out
        print(f"[3] {str(dtype)[6:]} LinearKernel Gram(sym=True) 50 x len "
              f"100: {sec:.3f} s ({50 * 51 // 2} pairs)")

    (rejected, TU, c), sec = synced(lambda: skt.hypothesis_test(
        H64, T64, rbf, dyadic_order=1, verbose=True))
    print(f"[4] hypothesis_test 32 vs 32 x len 200, dyadic 1: MMD {float(TU)}"
          f", threshold {c}, rejected {rejected}, {sec:.3f} s")

    launches = {("gen", F32): cuda_gen.COUNTS["float32"],
                ("gen", F64): cuda_gen.COUNTS["float64"],
                ("inc", F32): cuda_solver.COUNTS["float32"],
                ("inc", F64): cuda_solver.COUNTS["float64"]}
    plain_calls = cuda_gen.COUNTS["plain"] + cuda_solver.COUNTS["plain"]
    print(f"[2-4] launches on the main path: "
          f"{ {instances[k]: v for k, v in launches.items()} }, "
          f"plain-version calls {plain_calls}")
    for k, n in launches.items():
        check(n > 0, f"{instances[k]} was never launched on the main path")
    check(plain_calls == 0, "a plain version ran on the main path")

    # ---- checks of phases 2-4 against plain versions --------------------
    pick = torch.Generator(device="cpu").manual_seed(2)
    ii = torch.randint(0, A, (4,), generator=pick).to(dev)
    jj = torch.randint(0, A, (4,), generator=pick).to(dev)
    for dtype in (F64, F32):
        limit = F64_RTOL if dtype == F64 else F32_RTOL_LONG
        X, Y = X64.to(dtype), Y64.to(dtype)
        G_sym = main[(dtype, "compute_Gram(X, X, sym=True)")]
        G_xy = main[(dtype, "compute_Gram(X, Y)")]
        for label, out in ((k[1], v) for k, v in main.items()
                           if k[0] == dtype):
            check(bool(torch.isfinite(out).all()), f"{label}: non-finite")
        check(G_sym.shape == (A, A) and G_xy.shape == (A, A), "Gram shapes")
        check(torch.equal(G_sym, G_sym.T), "sym Gram is not exactly symmetric")
        for Yv, G, what in ((Y, G_xy, "Gram(X, Y)"), (X, G_sym, "Gram(X, X)")):
            label = f"{str(dtype)[6:]} {what} 4 random pairs"
            want = cuda_gen.rbf_gen_solve_final_plain(X, Yv, ii, jj, 1.0, 1)
            r = compare("gen", dtype, G[ii, jj], want, limit, label)
            print(f"[2] {label} vs plain version: rel {r:.2e} "
                  f"(limit {limit:.0e})")
        lin_v = main[(dtype, "sig_gram_lincomb(X, Y, W, pair_chunk=128)")]
        r = abs(float(lin_v - G_xy.mean())) / abs(float(G_xy.mean()))
        check(r <= (1e-12 if dtype == F64 else 1e-5),
              f"lincomb vs Gram mean rel {r:.2e}")
        print(f"[2] {str(dtype)[6:]} lincomb vs mean of Gram(X, Y): rel "
              f"{r:.2e}")
    g32 = main[(F32, "compute_Gram(X, Y)")].double()
    g64 = main[(F64, "compute_Gram(X, Y)")]
    r = float((g32 - g64).abs().max() / g64.abs().max())
    check(r <= F32_VS_F64, f"f32 Gram vs f64 Gram {r:.2e}")
    print(f"[2] float32 Gram(X, Y) vs float64 Gram(X, Y): max abs err / max "
          f"|K| {r:.2e} (limit {F32_VS_F64:.0e}); max rel err "
          f"{rel_err(g32, g64):.2e}; |K| in [{float(g64.abs().min()):.3g}, "
          f"{float(g64.abs().max()):.3g}]")

    for dtype in (F64, F32):
        XL = XL64.to(dtype)
        want = skt.sig_gram(skt.LinearKernel(1.0), XL, XL, sym=True,
                            solver="scan")
        limit = F64_RTOL if dtype == F64 else F32_RTOL_SMALL
        r = compare("inc", dtype, main[(dtype, "linear")], want, limit,
                    f"{str(dtype)[6:]} LinearKernel Gram vs plain tier")
        print(f"[3] {str(dtype)[6:]} LinearKernel Gram vs plain tier: rel "
              f"{r:.2e} (limit {limit:.0e})")

    TU_plain = skt.sig_mmd(rbf, H64, T64, dyadic_order=1, solver="scan")
    err = abs(float(TU) - float(TU_plain))
    check(err <= F64_RTOL * max(1.0, abs(float(TU_plain))),
          f"hypothesis_test MMD vs plain tier abs err {err:.2e}")
    print(f"[4] hypothesis_test MMD vs plain tier: abs err {err:.2e}")

    # ---- kernel times beside their plain versions -----------------------
    P = 128
    Xt64 = make_paths(gen, P, L, 3, F64)
    Yt64 = make_paths(gen, P, L, 3, F64)
    ar = torch.arange(P, device=dev)
    timing = {}
    for dtype in (F32, F64):
        Xt, Yt = Xt64.to(dtype), Yt64.to(dtype)
        inc = double_difference(rbf.batch_kernel(Xt, Yt)).contiguous()
        limit = F64_RTOL if dtype == F64 else F32_RTOL_LONG
        runs = {
            "gen": (lambda: cuda_gen.rbf_gen_solve_final(
                        Xt, Yt, ar, ar, 1.0, 1),
                    lambda: cuda_gen.rbf_gen_solve_final_plain(
                        Xt, Yt, ar, ar, 1.0, 1)),
            "inc": (lambda: cuda_solver.inc_solve_final(inc, 1),
                    lambda: cuda_solver.inc_solve_final_plain(inc, 1)),
        }
        for kind, (kern, plain) in runs.items():
            got, want = kern(), plain()  # warm-up, and the comparison
            r = compare(kind, dtype, got, want, limit,
                        f"{instances[(kind, dtype)]} at {P} pairs")
            ms = event_ms(kern, 5)
            plain_ms = event_ms(plain, 1)
            timing[(kind, dtype)] = (ms, plain_ms)
            print(f"[t] {instances[(kind, dtype)]}: {P} pairs, len {L}, "
                  f"dyadic 1, dim 3: kernel {ms:.3f} ms, plain "
                  f"{plain_ms:.3f} ms, rel {r:.2e} ({card})")

    replaces = {
        ("gen", F32): ("sigkernel_tpu/ops/pallas_gen32.py:143",
                       ["sigkernel_tpu/ops/pallas_fused.py:193",
                        "sigkernel_tpu/ops/pallas_fused.py:351"]),
        ("gen", F64): ("sigkernel_tpu/ops/pallas_df64.py:1066", []),
        ("inc", F32): ("sigkernel_tpu/ops/pallas_solver.py:115",
                       ["sigkernel_tpu/ops/pallas_solver.py:764"]),
        ("inc", F64): ("sigkernel_tpu/ops/pallas_df64.py:298",
                       ["sigkernel_tpu/ops/pallas_df64.py:607"]),
    }
    source = {"gen": "sigkernel_tpu_torch/csrc/rbf_gen_wavefront.cu",
              "inc": "sigkernel_tpu_torch/csrc/inc_wavefront.cu"}
    kernels = []
    for key, name in instances.items():
        rep, also = replaces[key]
        ms, plain_ms = timing[key]
        kernels.append({"name": name, "route": "cuda", "source": source[key[0]],
                         "replaces": rep, "also_replaces": also,
                         "launches": launches[key],
                         "max_abs_err": max_abs[key], "ms": ms,
                         "plain_ms": plain_ms})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
