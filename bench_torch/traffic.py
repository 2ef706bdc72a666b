"""The one traffic generator: it reads a mix's data file
(``bench_torch/traffic/<mix>.json``) and turns it into the calls a run
makes, the reference's answer to each, and the numbers compared.

A mix names its ``kind``: the estimator of the program it calls, and the
reference's answer, in a file of its own (``kinds/<kind>.py``), so a new
estimator is a new file. It names the batch of paths drawn for each call
(``paths``, in the order drawn), the inputs that require a gradient
(``grad``: paths by name, and the static kernel's parameter by its key),
the estimator's options, and how many of the window's calls are compared
with the reference afterwards (``check_calls``). Every call draws fresh
paths, ``cumsum(normal) / sqrt(length)``, on the device from the run's
seed and its own index, so no result carries from one call to the next and
any call's inputs can be drawn again.
"""
from __future__ import annotations

import hashlib
import math
from pathlib import Path

import torch

from . import named


def call_seed(seed: int, call: int) -> int:
    """The generator seed of call ``call`` of a run seeded ``seed``."""
    h = hashlib.sha256(f"{seed}:{call}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def draw(mix, cfg, seed, call, device):
    """The paths of one call, in float64, by name."""
    gen = torch.Generator(device=device)
    gen.manual_seed(call_seed(seed, call))
    L, D = cfg["length"], cfg["dim"]
    out = {}
    for name, n in mix["paths"].items():
        z = torch.randn(n, L, D, generator=gen, device=device,
                        dtype=torch.float64)
        out[name] = z.cumsum(dim=1) / math.sqrt(L)
    return out


def leaves(cell, paths, dtype):
    """The call's inputs in ``dtype``: the paths, and the static kernel's
    parameter as a tensor; those named in the mix's ``grad`` require a
    gradient. Returns ``(paths by name, parameter)``."""
    want, name = set(cell.mix.get("grad", ())), cell.static.PARAM
    x = {k: v.to(dtype, copy=True).requires_grad_(k in want)
         for k, v in paths.items()}
    dev = next(iter(paths.values())).device
    p = torch.tensor(cell.config[name], dtype=dtype, device=dev,
                     requires_grad=name in want)
    return x, p


def program_kernel(skt, cell, p):
    """The program's static kernel of the configuration, on parameter
    ``p``."""
    return getattr(skt, cell.config["static_kernel"])(p)


def reference_kernel(cell, paths):
    """The reference's static kernel of the configuration, in float64."""
    p = next(iter(paths.values())).new_tensor(cell.config[cell.static.PARAM])
    return cell.static.Kernel(p)


def grads(cell, x, p):
    """The gradients the mix asks for, ``d<name>``, after ``backward``."""
    want = cell.mix.get("grad", ())
    out = {f"d{k}": x[k].grad for k in want if k in x}
    if cell.static.PARAM in want:
        out[f"d{cell.static.PARAM}"] = p.grad
    return out


def pick(cell, out):
    """The reference's outputs that the program returns: the value and the
    gradients the mix asks for."""
    keep = {"value"} | {f"d{k}" for k in cell.mix.get("grad", ())}
    return {k: v for k, v in out.items() if k in keep}


def grad_floats(mix, cfg):
    """Values a call's requested gradients write: a path's ``length x
    dim`` each, one for a scalar parameter."""
    n, L, D = mix["paths"], cfg["length"], cfg["dim"]
    return sum(n[k] * L * D if k in n else 1 for k in mix.get("grad", ()))


def kind(name, bench=named.BENCH):
    """The kind of call ``name``: its module ``kinds/<name>.py``, with
    ``pairs(mix)``, ``floats_out(mix, cfg)``, ``run(skt, cell, paths,
    dtype)`` (the program's call, returning its outputs by name) and
    ``reference(cell, paths)`` (the reference's, by the same names). A name
    with no such file is refused."""
    return named.load(Path(bench) / "kinds", name, "kind of call")


def compare(out, want):
    """``max |out - want| / max |want|`` for each of the reference's
    outputs, in float64; infinite where the program gave none or a
    non-finite one."""
    nums = {}
    for k, w in want.items():
        o = out.get(k)
        if o is None or o.shape != w.shape or not bool(torch.isfinite(o).all()):
            nums[k] = math.inf
            continue
        scale = float(w.abs().max())
        o = o.to(w.device, torch.float64)
        nums[k] = float((o - w.double()).abs().max()) / max(scale, 1e-300)
    return nums
