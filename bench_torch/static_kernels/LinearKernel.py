"""The linear static kernel ``scale^2 <x, y>``, as the program's
``LinearKernel``, in plain PyTorch: its point-pair values, their VJP and
their operations."""
import torch

# the configuration's key of the kernel's parameter, and its gradient's name
PARAM = "scale"


class Kernel:
    def __init__(self, scale):
        self.p = scale

    def gram(self, x, y):
        """``(G, None)``: ``G = scale^2 <x_m, y_n>``, ``(B, M, N)``."""
        return torch.bmm(x, y.transpose(1, 2)) * (self.p * self.p), None

    def vjp(self, x, y, G, _, ctG):
        """Gradients in ``x``, ``y`` and ``scale`` of ``sum(ctG * G)``."""
        s2 = self.p * self.p
        dscale = 2.0 * torch.sum(ctG * G) / self.p
        return s2 * torch.bmm(ctG, y), s2 * torch.bmm(ctG.transpose(1, 2), x), dscale


def point_ops(D, grad):
    """Operations a point pair: the value ``2 D + 1``, with ``grad`` its
    VJP ``4 D + 2`` as well."""
    return 2 * D + 1 + (4 * D + 2 if grad else 0)
