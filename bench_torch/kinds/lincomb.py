"""``sig_gram_lincomb(kernel, X, Y, W)`` with ``W = 1 / (nX nY)``, and
``.backward()``: every pair of ``X`` and ``Y``."""
from bench_torch import reference as ref
from bench_torch import traffic as tf


def pairs(mix):
    n = list(mix["paths"].values())
    return n[0] * n[1]


def floats_out(mix, cfg):
    return 1 + tf.grad_floats(mix, cfg)


def run(skt, cell, paths, dtype):
    mix, cfg = cell.mix, cell.config
    x, p = tf.leaves(cell, paths, dtype)
    X, Y = x["X"], x["Y"]
    W = X.new_full((X.shape[0], Y.shape[0]), 1.0 / (X.shape[0] * Y.shape[0]))
    S = skt.sig_gram_lincomb(
        tf.program_kernel(skt, cell, p), X, Y, W,
        dyadic_order=cfg["dyadic_order"], pair_chunk=mix["pair_chunk"],
        grad_solver=cfg["grad_solver"])
    S.backward()
    return {"value": S.detach(), **tf.grads(cell, x, p)}


def reference(cell, paths):
    X, Y = paths["X"], paths["Y"]
    W = X.new_full((X.shape[0], Y.shape[0]), 1.0 / (X.shape[0] * Y.shape[0]))
    S, dX, dY, dp = ref.lincomb_grads(X, Y, W, tf.reference_kernel(cell, paths),
                                      2 ** cell.config["dyadic_order"])
    return tf.pick(cell, {"value": S, "dX": dX, "dY": dY,
                          f"d{cell.static.PARAM}": dp})
