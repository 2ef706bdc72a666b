"""Build the CUDA kernels at first use and bind them with ``ctypes``.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` into one shared library
with a plain ``extern "C"`` interface (no PyTorch headers, so the build
takes seconds). The library lands in
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
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Hopper: the most dynamic shared memory one block may opt in to (227 KB).
SMEM_BYTES = 232448

_P, _I, _I64, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_double
_SIGNATURES = {
    # inc, out, P, Mb, Nb, f, naive, device, stream
    "sk_inc_wavefront_f32": [_P, _P, _I64, _I, _I, _I, _I, _I, _P],
    "sk_inc_wavefront_f64": [_P, _P, _I64, _I, _I, _I, _I, _I, _P],
    # rows, cols, ri, ci, out, P, Lr, Lc, D, f, sigma, naive, device, stream
    "sk_rbf_gen_wavefront_f32": [_P, _P, _P, _P, _P, _I64, _I, _I, _I, _I,
                                 _D, _I, _I, _P],
    "sk_rbf_gen_wavefront_f64": [_P, _P, _P, _P, _P, _I64, _I, _I, _I, _I,
                                 _D, _I, _I, _P],
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
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *_NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sorted(_CSRC.glob("*.cu"))]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out.parent / "nvcc.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
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


def check_rows(rows: int, itemsize: int, what: str) -> None:
    """The one size bound of the wavefront kernels: a ring of three
    diagonals of the shorter refined side in one block's shared memory."""
    if 3 * (rows + 1) * itemsize > SMEM_BYTES:
        raise ValueError(
            f"{what}: the shorter refined side has {rows} rows; the kernel "
            f"keeps 3 x (rows + 1) values of {itemsize} bytes in shared "
            f"memory, at most {SMEM_BYTES} bytes "
            f"({SMEM_BYTES // (3 * itemsize) - 1} rows)")


def stream_args(t):
    """``(device index, current stream handle)`` for a launch on ``t``'s card."""
    import torch

    return t.device.index, torch.cuda.current_stream(t.device).cuda_stream


def check(code: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if code != 0:
        msg = library().sk_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")
