"""Models built on the port's estimators."""
from .mmd_flow import MMDFlow, mmd_flow_step  # noqa: F401
