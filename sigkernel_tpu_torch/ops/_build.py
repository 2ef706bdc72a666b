"""Build the CUDA kernels at first use and bind them with ``ctypes``.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library with
a plain ``extern "C"`` interface (no PyTorch headers, so the build takes
under a minute: about 45 s on the H100 machine, most of it the 72
instances of K3<gen>'s band kernel). The library lands in
``build/sigkernel_tpu_torch/<hash of the sources>/libsigkernel_cuda.so``
under the directory that holds the package, so a library built from other
sources is never loaded. ``nvcc``'s resource report (``-Xptxas -v``) is kept
beside it as ``nvcc.log``.

Nothing here runs at import time: the CPU tests import every module on a
machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_ROOT = (Path(__file__).resolve().parents[2] / "build"
               / "sigkernel_tpu_torch")
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_NVCC_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v"]

# Hopper: the most dynamic shared memory one block may opt in to (227 KB).
SMEM_BYTES = 232448

_P, _I, _I64, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_double
_SIGNATURES = {
    # inc, out, scratch, counters, P, Mb, Nb, f, nbands, naive, device,
    # stream
    "sk_inc_wavefront_f32": [_P, _P, _P, _P, _I64, _I, _I, _I, _I, _I, _I,
                             _P],
    "sk_inc_wavefront_f64": [_P, _P, _P, _P, _I64, _I, _I, _I, _I, _I, _I,
                             _P],
    # rows, cols, ri, ci, out, scratch, counters, P, Lr, Lc, D, f, sigma,
    # nbands, naive, device, stream
    "sk_rbf_gen_wavefront_f32": [_P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I,
                                 _I, _D, _I, _I, _I, _P],
    "sk_rbf_gen_wavefront_f64": [_P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I,
                                 _I, _D, _I, _I, _I, _P],
    # inc, out, stack, scratch, counters, P, Mb, Nb, f, nbands, naive,
    # device, stream
    "sk_inc_stack_f32": [_P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _I, _I,
                         _P],
    "sk_inc_stack_f64": [_P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _I, _I,
                         _P],
    # inc, out, sparse, scratch, counters, P, Mb, Nb, f, W, nbands, naive,
    # device, stream
    "sk_inc_sparse_f32": [_P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _I, _I,
                          _I, _P],
    "sk_inc_sparse_f64": [_P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _I, _I,
                          _I, _P],
    # inc, bd, bottom, scratch, counters, P, Mb, Nb, f, row0, rows, nbands,
    # flip, naive, device, stream
    "sk_stripe_f32": [_P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _I, _I, _I,
                      _I, _I, _P],
    "sk_stripe_f64": [_P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _I, _I, _I,
                      _I, _I, _P],
    # inc, bd, bottom, stack, scratch, counters, P, Mb, Nb, f, row0, rows,
    # nbands, flip, naive, device, stream
    "sk_stripe_stack_f32": [_P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _I,
                            _I, _I, _I, _I, _P],
    "sk_stripe_stack_f64": [_P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _I,
                            _I, _I, _I, _I, _P],
    # rows, cols, ri, ci, out, stack, scratch, counters, P, Lr, Lc, D, f,
    # sigma, nbands, naive, device, stream
    "sk_rbf_gen_stack_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I,
                             _I, _D, _I, _I, _I, _P],
    "sk_rbf_gen_stack_f64": [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I,
                             _I, _D, _I, _I, _I, _P],
    # inc, stack, ct, P, Mb, Nb, f, naive, device, stream
    "sk_adjoint_inc_f32": [_P, _P, _P, _I64, _I, _I, _I, _I, _I, _P],
    "sk_adjoint_inc_f64": [_P, _P, _P, _I64, _I, _I, _I, _I, _I, _P],
    # inc, stack, bd, ct, P, Mb, Nb, f, row0, rows, naive, device, stream
    "sk_adjoint_stripe_f32": [_P, _P, _P, _P, _I64, _I, _I, _I, _I, _I, _I,
                              _I, _P],
    "sk_adjoint_stripe_f64": [_P, _P, _P, _P, _I64, _I, _I, _I, _I, _I, _I,
                              _I, _P],
    # inc, stack, bd, ct, scratch, counters, P, Mb, Nb, f, row0, rows,
    # nbands, naive, device, stream
    "sk_adjoint_band_f32": [_P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _I,
                            _I, _I, _I, _P],
    "sk_adjoint_band_f64": [_P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _I,
                            _I, _I, _I, _P],
    # inc, sparse, scratch, ct, P, Mb, Nb, f, W, naive, device, stream
    "sk_adjoint_ckpt_f32": [_P, _P, _P, _P, _I64, _I, _I, _I, _I, _I, _I,
                            _P],
    "sk_adjoint_ckpt_f64": [_P, _P, _P, _P, _I64, _I, _I, _I, _I, _I, _I,
                            _P],
    # inc, sparse, ct, scratch, counters, P, Mb, Nb, f, W, nbands, naive,
    # device, stream
    "sk_adjoint_ckpt_band_f32": [_P, _P, _P, _P, _P, _I64, _I, _I, _I, _I,
                                 _I, _I, _I, _P],
    "sk_adjoint_ckpt_band_f64": [_P, _P, _P, _P, _P, _I64, _I, _I, _I, _I,
                                 _I, _I, _I, _P],
    # rows, cols, ri, ci, stack, ct, P, Lr, Lc, D, f, sigma, transpose,
    # naive, device, stream
    "sk_adjoint_gen_f32": [_P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _D,
                           _I, _I, _I, _P],
    "sk_adjoint_gen_f64": [_P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _D,
                           _I, _I, _I, _P],
    # rows, cols, ri, ci, ct, wt, stack, scratch, counters, P, Lr, Lc, D, f,
    # sigma, nbands, transpose, naive, device, stream
    "sk_adjoint_gen_band_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I,
                                _I, _I, _I, _D, _I, _I, _I, _I, _P],
    "sk_adjoint_gen_band_f64": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I,
                                _I, _I, _I, _D, _I, _I, _I, _I, _P],
    # X, Y, ii, jj, ct, dx, dy, part, es, dsigma, P, M, N, D, sigma, band,
    # chunk, device, stream
    "sk_rbf_dd_vjp_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I,
                          _I, _I, _D, _I, _I64, _I, _P],
    "sk_rbf_dd_vjp_f64": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I,
                          _I, _I, _D, _I, _I64, _I, _P],
    # X, Y, ii, jj, out, P, M, N, D, sigma, device, stream
    "sk_rbf_gen_increments_f32": [_P, _P, _P, _P, _P, _I64, _I, _I, _I, _D,
                                  _I, _P],
    "sk_rbf_gen_increments_f64": [_P, _P, _P, _P, _P, _I64, _I, _I, _I, _D,
                                  _I, _P],
    # inc, inc_d, inc_dd, out, scratch, counters, P, Mb, Nb, f, nbands,
    # device, stream
    "sk_deriv_wavefront_f32": [_P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _I,
                               _I, _P],
    "sk_deriv_wavefront_f64": [_P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _I,
                               _I, _P],
    # A, B, ii, jj, out, P, Mb, Nb, D, device, stream
    "sk_linear_gen_increments_f32": [_P, _P, _P, _P, _P, _I64, _I, _I, _I,
                                     _I, _P],
    "sk_linear_gen_increments_f64": [_P, _P, _P, _P, _P, _I64, _I, _I, _I,
                                     _I, _P],
    # A, B, ii, jj, ct, U, V, upart, vpart, P, Mb, Nb, D, device, stream
    "sk_linear_dd_vjp_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I,
                             _I, _I, _I, _P],
    "sk_linear_dd_vjp_f64": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I,
                             _I, _I, _I, _P],
    # rows, cols, ri, ci, out, P, Lr, Lc, D, f, naive, device, stream
    "sk_linear_gen_wavefront_f32": [_P, _P, _P, _P, _P, _I64, _I, _I, _I, _I,
                                    _I, _I, _P],
    "sk_linear_gen_wavefront_f64": [_P, _P, _P, _P, _P, _I64, _I, _I, _I, _I,
                                    _I, _I, _P],
}

_lib = None
build_seconds = None  # wall time of the build in this process, if it built


def find_nvcc() -> str:
    """``nvcc`` on ``PATH``, else under ``$CUDA_HOME``, else the usual
    ``/usr/local/cuda``; raises if there is none."""
    candidates = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(_NVCC_FLAGS).encode())
    return _BUILD_ROOT / h.hexdigest()[:16] / "libsigkernel_cuda.so"


def _build(out: Path) -> None:
    global build_seconds
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc, tag = find_nvcc(), f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = []  # one nvcc per source, all running at once
    for src in sorted(_CSRC.glob("*.cu")):
        obj = out.with_name(f"{src.stem}.{tag}.o")
        cmd = [nvcc, *_NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], None
    for cmd, _, proc in jobs:  # wait for every process, failed or not
        logs.append(proc.communicate()[0])
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, logs[-1])
    tmp = out.with_name(f"{out.name}.{tag}")
    if failed is None:
        cmd = [nvcc, *_ARCH, "-shared", "-o", str(tmp),
               *[str(obj) for _, obj, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed = (cmd, proc.returncode, logs[-1])
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    (out.parent / "nvcc.log").write_text("".join(logs))
    if failed is not None:
        cmd, code, log = failed
        raise RuntimeError(f"nvcc failed ({code}):\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
    build_seconds = time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    if _lib is None:
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.sk_error_string.argtypes = [ctypes.c_int]
        lib.sk_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def max_rows(itemsize: int) -> int:
    """The size bound of the one-block wavefront kernels (K3<inc>, K6, and
    K3<gen>, K3<inc, boundary> and K8 past f = 32): the most rows whose ring
    of three diagonals fits one block's shared memory (9,684 in double,
    19,369 in float). Past it the routes take stripes (``cuda_blocked``);
    the band kernels have no such bound."""
    return SMEM_BYTES // (3 * itemsize) - 1


def check_rows(rows: int, itemsize: int, what: str) -> None:
    """Raise unless ``rows`` (the shorter refined side of a one-block
    wavefront) is within :func:`max_rows`."""
    if rows > max_rows(itemsize):
        raise ValueError(
            f"{what}: the shorter refined side has {rows} rows; the kernel "
            f"keeps 3 x (rows + 1) values of {itemsize} bytes in shared "
            f"memory, at most {SMEM_BYTES} bytes "
            f"({max_rows(itemsize)} rows)")


def dtype_key(t) -> str:
    """``"float32"`` / ``"float64"``: the launch counters' key for ``t``."""
    return str(t.dtype).removeprefix("torch.")


def stream_args(t):
    """``(device index, current stream handle)`` for a launch on ``t``'s card."""
    import torch

    return t.device.index, torch.cuda.current_stream(t.device).cuda_stream


def check(code: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if code != 0:
        msg = library().sk_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")


def launch(what: str, fns, counts, t, *args, key=None) -> None:
    """Call ``fns[t.dtype]`` of the library with ``args`` on ``t``'s card and
    current stream, raise on a CUDA error, and count the launch in
    ``counts`` under ``key`` (default: ``t``'s dtype)."""
    fn = getattr(library(), fns[t.dtype])
    device, stream = stream_args(t)
    check(fn(*args, device, stream), what)
    counts[key or dtype_key(t)] += 1
