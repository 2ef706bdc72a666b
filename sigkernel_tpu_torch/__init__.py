"""sigkernel_tpu_torch: the signature-kernel library in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

The port of :mod:`sigkernel_tpu` (which stays the reference). This package
imports ``torch`` and never ``jax``. It covers the forward path: static
kernels, the Goursat PDE wavefront solve, and the kernel, Gram, Gram
linear-combination, MMD and distance estimators plus the two-sample test.
On CUDA tensors the solve runs in two kernels built from ``csrc/`` at first
use: K1 generates RBF increments in-kernel (:mod:`.ops.cuda_gen`), K2 sweeps
a precomputed increment grid (:mod:`.ops.cuda_solver`). On the CPU the plain
PyTorch loop (:mod:`.ops.scan_solver`) runs.
"""

__version__ = "0.1.0"

from .kernels import StaticKernel, LinearKernel, RBFKernel  # noqa: F401
from .convert import static_kernel_from_numpy  # noqa: F401
from .sigkernel import (  # noqa: F401
    SigKernel,
    sig_kernel,
    sig_gram,
    sig_gram_lincomb,
    sig_distance,
    sig_mmd,
    sig_scoring_rule,
    sig_expected_scoring_rule,
)
from .models.mmd_flow import MMDFlow, mmd_flow_step  # noqa: F401
from .stats import hypothesis_test, c_alpha  # noqa: F401
from . import ops  # noqa: F401
from . import utils  # noqa: F401
