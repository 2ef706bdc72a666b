"""Models built on the port's estimators."""
from .classifier import SigKernelSVC  # noqa: F401
from .mmd_flow import MMDFlow, mmd_flow_step  # noqa: F401
