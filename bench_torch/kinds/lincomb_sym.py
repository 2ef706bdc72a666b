"""``sig_gram_lincomb(kernel, X, X, W, sym=True)`` with ``W = (1 - I) / (n
(n - 1))``, and ``.backward()``: the X-X term of the unbiased signature
MMD^2, as ``sig_mmd`` sums it, on the pairs ``i <= j`` of ``X``. The
reference sums all ``n^2`` ordered pairs, so it shares no symmetry with the
program."""
import torch

from bench_torch import reference as ref
from bench_torch import traffic as tf


def pairs(mix):
    n = mix["paths"]["X"]
    return n * (n + 1) // 2


def floats_out(mix, cfg):
    return 1 + tf.grad_floats(mix, cfg)


def weights(X):
    """The unbiased MMD^2's X-X weights: ``1 / (n (n - 1))`` off the
    diagonal, 0 on it."""
    n = X.shape[0]
    eye = torch.eye(n, dtype=X.dtype, device=X.device)
    return (1.0 - eye) / (n * (n - 1.0))


def run(skt, cell, paths, dtype):
    mix, cfg = cell.mix, cell.config
    x, p = tf.leaves(cell, paths, dtype)
    X = x["X"]
    S = skt.sig_gram_lincomb(
        tf.program_kernel(skt, cell, p), X, X, weights(X), sym=True,
        dyadic_order=cfg["dyadic_order"], pair_chunk=mix["pair_chunk"],
        grad_solver=cfg["grad_solver"])
    S.backward()
    return {"value": S.detach(), **tf.grads(cell, x, p)}


def reference(cell, paths):
    X = paths["X"]
    S, dX, dY, dp = ref.lincomb_grads(X, X, weights(X),
                                      tf.reference_kernel(cell, paths),
                                      2 ** cell.config["dyadic_order"])
    # X fills both slots: its gradient is the sum of the two
    return tf.pick(cell, {"value": S, "dX": dX + dY,
                          f"d{cell.static.PARAM}": dp})
