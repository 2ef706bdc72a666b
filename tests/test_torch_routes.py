"""The port's one route resolver, over its whole matrix, and the port's
independence from JAX."""
import os
import subprocess
import sys

import pytest
import torch

import sigkernel_tpu_torch as skt
from sigkernel_tpu_torch.ops import routes


class _ScaledRBF(skt.RBFKernel):
    """Not exactly ``RBFKernel``: must not take the RBF generation kernel."""


_KERNELS = {
    "rbf": skt.RBFKernel(0.5),
    "linear": skt.LinearKernel(1.0),
    "rbf_subclass": _ScaledRBF(0.5),
    "linear_subclass": skt.Linear_ID_Kernel(),  # must not take K6 either
    "functional": skt.RBF_SQR_Kernel(0.5, 1.0),
    "grid": None,  # a ready increment grid (ops.solve)
}

# (kernel, device type, solver) -> family, or the error it raises
_EXPECTED = {}
for _k in _KERNELS:
    for _dev in ("cpu", "cuda"):
        _EXPECTED[(_k, _dev, "scan")] = "scan"
    _EXPECTED[(_k, "cpu", "auto")] = "scan"
    _EXPECTED[(_k, "cpu", "cuda")] = ValueError
    for _solver in ("auto", "cuda"):
        _EXPECTED[(_k, "cuda", _solver)] = {"rbf": "gen",
                                            "linear": "lgen"}.get(_k, "inc")


@pytest.mark.parametrize("kernel,device,solver", sorted(_EXPECTED))
def test_resolve_family_matrix(kernel, device, solver):
    want = _EXPECTED[(kernel, device, solver)]
    if want is ValueError:
        with pytest.raises(ValueError, match="CUDA"):
            routes.resolve_family(_KERNELS[kernel], device, solver)
    else:
        assert routes.resolve_family(_KERNELS[kernel], device,
                                     solver) == want
        assert want in routes.FAMILIES


@pytest.mark.parametrize("solver", ["pallas", "gen", "", "CUDA"])
def test_unknown_solver_lists_the_options(solver):
    with pytest.raises(ValueError, match="'auto', 'scan', 'cuda'"):
        routes.resolve_family(skt.RBFKernel(1.0), "cuda", solver)


# (family, input dtype, grad_solver) -> backward dtype
_F32, _F64 = torch.float32, torch.float64
_BWD = {}
for _fam in routes.FAMILIES:
    for _dt in (_F32, _F64):
        for _grade in routes.GRAD_SOLVERS:
            _BWD[(_fam, _dt, _grade)] = (
                _F32 if _fam != "scan" and _grade == "f32" else _dt)


@pytest.mark.parametrize("family,dtype,grade", sorted(
    _BWD, key=lambda k: (k[0], str(k[1]), k[2])))
def test_backward_dtype_matrix(family, dtype, grade):
    """f64 in: "f32" is the float32 chain, "auto"/"df64" native double; f32
    in: float32; the plain (scan) family always at the input precision."""
    kernel, device, solver = {
        "gen": (_KERNELS["rbf"], "cuda", "auto"),
        "lgen": (_KERNELS["linear"], "cuda", "auto"),
        "inc": (_KERNELS["functional"], "cuda", "auto"),
        "scan": (_KERNELS["rbf"], "cpu", "auto")}[family]
    route = routes.resolve(kernel, device, solver, dtype, grade)
    assert route == routes.Route(family, _BWD[(family, dtype, grade)])


def test_unknown_grad_solver_raises():
    with pytest.raises(ValueError, match="'auto', 'f32', 'df64'"):
        routes.resolve(None, "cuda", "auto", torch.float64, "f64")


# the derivative Gram: (device type, solver, an input needs a gradient) ->
# route, or the error it raises
_DERIV = {}
for _dev in ("cpu", "cuda"):
    for _grad in (False, True):
        _DERIV[(_dev, "scan", _grad)] = "scan"
        _DERIV[(_dev, "cuda", _grad)] = (
            "CUDA tensors" if _dev == "cpu" else
            "forward only" if _grad else "cuda")
        _DERIV[(_dev, "auto", _grad)] = (
            "scan" if _dev == "cpu" else "forward only" if _grad else "cuda")


@pytest.mark.parametrize("device,solver,needs_grad", sorted(_DERIV))
def test_resolve_derivatives_matrix(device, solver, needs_grad):
    """K5 for CUDA tensors, forward only: an input that needs a gradient
    raises there rather than come back detached."""
    want = _DERIV[(device, solver, needs_grad)]
    if want in routes.DERIV_ROUTES:
        assert routes.resolve_derivatives(device, solver, needs_grad) == want
    else:
        with pytest.raises(ValueError, match=want):
            routes.resolve_derivatives(device, solver, needs_grad)


def test_resolve_derivatives_unknown_solver_lists_the_options():
    with pytest.raises(ValueError, match="'auto', 'scan', 'cuda'"):
        routes.resolve_derivatives("cuda", "pallas", False)


def test_import_pulls_in_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, sigkernel_tpu_torch, sigkernel_tpu_torch.ops.solve, "
            "sigkernel_tpu_torch.ops.cuda_gen, sigkernel_tpu_torch.stats, "
            "sigkernel_tpu_torch.ops.incvjp, sigkernel_tpu_torch.ops.cuda_deriv, "
            "sigkernel_tpu_torch.ops.cuda_lgen, "
            "sigkernel_tpu_torch.models.mmd_flow\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'sigkernel_tpu'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
