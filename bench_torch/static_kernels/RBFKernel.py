"""The RBF static kernel ``exp(-|x - y|^2 / sigma)`` (divided by
``sigma``, not its square, as the program's ``RBFKernel``), in plain
PyTorch: its point-pair values, their VJP and their operations."""
import torch

# the configuration's key of the kernel's parameter, and its gradient's name
PARAM = "sigma"


def _sqdist(x, y):
    """``|x_m - y_n|^2``, ``(B, M, N)``, summed coordinate by coordinate."""
    d = torch.zeros(x.shape[0], x.shape[1], y.shape[1], dtype=x.dtype,
                    device=x.device)
    for c in range(x.shape[2]):
        d.add_((x[:, :, c, None] - y[:, None, :, c]).square_())
    return d


class Kernel:
    def __init__(self, sigma):
        self.p = sigma

    def gram(self, x, y):
        """``(G, dist)`` of the pairs ``(x[b], y[b])``: ``exp(-dist /
        sigma)`` and ``dist = |x_m - y_n|^2``, ``(B, M, N)``."""
        dist = _sqdist(x, y)
        return torch.exp(-dist / self.p), dist

    def vjp(self, x, y, G, dist, ctG):
        """Gradients in ``x``, ``y`` and ``sigma`` of ``sum(ctG * G)``;
        ``ctG`` is overwritten."""
        s = self.p
        dsigma = torch.sum(ctG * G * dist) / (s * s)
        w = ctG.mul_(G).mul_(-2.0 / s)              # d/d dist, times 2
        dx = x * w.sum(2, keepdim=True) - torch.bmm(w, y)
        dy = y * w.sum(1)[:, :, None] - torch.bmm(w.transpose(1, 2), x)
        return dx, dy, dsigma


def point_ops(D, grad):
    """Operations a point pair: the value ``6 D + 6`` (``exp`` counted as
    one), with ``grad`` its VJP ``10 D + 13`` as well."""
    return 6 * D + 6 + (10 * D + 13 if grad else 0)
