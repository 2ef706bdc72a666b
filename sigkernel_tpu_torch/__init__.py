"""sigkernel_tpu_torch: the signature-kernel library in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

The port of :mod:`sigkernel_tpu` (which stays the reference). This package
imports ``torch`` and never ``jax``. It covers the static kernels (with the
functional-data ones), the Goursat PDE wavefront solve and its adjoint, and
the kernel, Gram, Gram linear-combination, MMD, distance, scoring-rule and
derivative-Gram estimators, the two-sample test, CHSIC and the MMD-flow
trainer. On CUDA tensors the solves run in kernels built from ``csrc/`` at
first use: K1 generates RBF increments in-kernel (:mod:`.ops.cuda_gen`), K6
Linear ones (:mod:`.ops.cuda_lgen`), K2 sweeps a precomputed increment grid
(:mod:`.ops.cuda_solver`), K3/K4 carry the adjoint, and K5 the derivative
Gram (:mod:`.ops.cuda_deriv`). On the CPU the plain PyTorch loops
(:mod:`.ops.scan_solver`) run. The path transforms (:mod:`.transforms`)
and the precomputed-Gram SVC (:class:`.models.SigKernelSVC`) run on the
paths' device too.
"""

__version__ = "0.1.0"

from .kernels import (  # noqa: F401
    StaticKernel,
    LinearKernel,
    RBFKernel,
    RBF_CEXP_Kernel,
    RBF_SQR_Kernel,
    Linear_ID_Kernel,
    RBF_ID_Kernel,
    CEXP,
    cos_exp_kernel,
)
from .convert import static_kernel_from_numpy  # noqa: F401
from .sigkernel import (  # noqa: F401
    SigKernel,
    sig_kernel,
    sig_gram,
    sig_gram_lincomb,
    sig_kernel_and_derivatives_gram,
    k_kgrad,
    sig_distance,
    sig_mmd,
    sig_scoring_rule,
    sig_expected_scoring_rule,
)
from .models.mmd_flow import MMDFlow, mmd_flow_step  # noqa: F401
from .transforms import transform, AddTime, LeadLag  # noqa: F401
from .stats import hypothesis_test, sig_chsic, SigCHSIC, c_alpha  # noqa: F401
from . import ops  # noqa: F401
from . import utils  # noqa: F401
