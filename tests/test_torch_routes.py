"""The port's one route resolver, over its whole matrix, and the port's
independence from JAX."""
import os
import subprocess
import sys

import pytest

import sigkernel_tpu_torch as skt
from sigkernel_tpu_torch.ops import routes


class _ScaledRBF(skt.RBFKernel):
    """Not exactly ``RBFKernel``: must not take the RBF generation kernel."""


_KERNELS = {
    "rbf": skt.RBFKernel(0.5),
    "linear": skt.LinearKernel(1.0),
    "rbf_subclass": _ScaledRBF(0.5),
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
        _EXPECTED[(_k, "cuda", _solver)] = "gen" if _k == "rbf" else "inc"


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


def test_import_pulls_in_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, sigkernel_tpu_torch, sigkernel_tpu_torch.ops.solve, "
            "sigkernel_tpu_torch.ops.cuda_gen, sigkernel_tpu_torch.stats\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'sigkernel_tpu'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
