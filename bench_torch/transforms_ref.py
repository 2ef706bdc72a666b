"""The reference's path transforms, in plain PyTorch, written from their
published description (the signature-kernel library's ``transform``: scale,
then the lead-lag embedding, then a time channel) and not from the
program's code.

- Lead-lag: a path ``x_0 .. x_{n-1}`` becomes the ``2 n - 1`` points
  ``(lag_k, lead_k)`` with ``lag_k = x_{floor(k / 2)}`` and ``lead_k =
  x_{ceil(k / 2)}``: ``(x_0, x_0), (x_0, x_1), (x_1, x_1), ...,
  (x_{n-1}, x_{n-1})``, the lag's channels first.
- Add-time: the channel ``t_k = k / (n - 1)``, from 0 to 1 in equal steps,
  put before the others.
"""
import torch


def lead_lag(x):
    """``(B, n, D)`` -> ``(B, 2 n - 1, 2 D)``."""
    k = torch.arange(2 * x.shape[1] - 1, device=x.device)
    return torch.cat([x[:, k // 2], x[:, (k + 1) // 2]], dim=2)


def add_time(x):
    """``(B, n, D)`` -> ``(B, n, D + 1)``, time first."""
    B, n, _ = x.shape
    t = torch.arange(n, dtype=torch.float64, device=x.device) / max(n - 1, 1)
    return torch.cat([t.to(x.dtype).expand(B, n)[..., None], x], dim=2)


def transform(x, at=False, ll=False, scale=1.0):
    """``scale`` times the paths, then lead-lag (``ll``), then add-time
    (``at``)."""
    x = scale * x
    if ll:
        x = lead_lag(x)
    if at:
        x = add_time(x)
    return x
